#!/usr/bin/env python3
"""Chip smoke of the PyTorch / H100 port (``src/repro_torch``).

Drives the port's twelve paths on one NVIDIA Hopper card, through the
entry points a user calls:

* the paper's wireless D-PSGD run: Eq. 2 capacities, Algorithm 2 rates at
  λ targets {0.1, 0.8}, then the full 21 840-parameter CNN trained with
  D-PSGD on 6 nodes at batch 25 over the 60 000-image synthetic set, each
  step replayed as one CUDA graph, with every gossip mix in the CUDA
  kernels of ``csrc/gossip_mix.cu``;
* serving recurrentgemma-2b at its published widths and full depth
  (``launch.serve.generate``: a 4096-token prompt at batch 4, then 32
  greedy tokens), with local attention's prefill in the CUDA kernel of
  ``csrc/flash_attention.cu`` and the RG-LRU recurrence in that of
  ``csrc/rglru_scan.cu``;
* serving rwkv6-7b at its published widths and full depth (32 layers,
  d_model 4096, 7.53 B parameters; the same prompt, batch and tokens), with
  the WKV recurrence of every prefill in the CUDA kernel of
  ``csrc/rwkv6_scan.cu``;
* training through the wireless simulator (``sim.simulate_dpsgd_cnn``, the
  driver behind Fig. 3's accuracy against simulated time) at the paper's
  size, one epoch of 400 rounds on ``compressed_int8`` and on ``static``,
  every int8 round in two CUDA kernels: the send (quantize with its error
  feedback, ``quantize_int8_ef`` of ``csrc/quantize.cu``) and the receive
  (``gossip_mix_q8`` with W whole, launched as a programmatic dependent);
* train-on-trace (``sim.train_cnn_on_traces``, Monte-Carlo families of the
  same epoch over precomputed traces): 4 seeds of ``compressed_int8`` and
  2 of ``fault_chaos`` (watchdog armed), one CUDA graph replayed per round
  for the whole family, each trace's int8 round in the send and receive
  kernels, each uncompressed round in the rows mix;
* serving deepseek-v2-lite-16b at its published widths and full depth
  (27 layers of MLA, 26 of them MoE of 64 experts top-6 plus 2 shared;
  15.5 B parameters, cast to bf16 as they are drawn), every MLA prefill's
  attention in the flash kernel (D 192, v 128 padded to it);
* serving seamless-m4t-large-v2's encoder-decoder at its published widths
  (12 + 12 layers, d_model 1024; the prompt's 4096 positions as 2048
  source frames and 2048 target tokens), its encoder's bidirectional,
  its decoder's causal and its cross attention's prefill in the flash
  kernel;
* training stablelm-3b over a precomputed wireless trace
  (``sim.train_model_on_traces(sim.batch.transformer_adapter(...))``) at
  its published widths (d_model 2560, 32 heads of 80, d_ff 6912, vocab
  50 304; 1 layer: 6 fp32 replicas of 32 would not fit the card), D-PSGD
  on 6 nodes at batch 4 x 512 tokens, each round one CUDA graph replay,
  every attention's forward in ``csrc/flash_attention.cu`` (with its
  log-sum-exp) and its backward in ``csrc/flash_attention_bwd.cu``;
* training recurrentgemma-2b (3 layers: rglru, rglru, local) and
  rwkv6-7b (1 layer) the same way at their published widths on 3 nodes,
  every RG-LRU scan's forward and backward in ``csrc/rglru_scan.cu`` and
  ``csrc/rglru_scan_bwd.cu``, every RWKV-6 scan's in ``csrc/rwkv6_scan.cu``
  and ``csrc/rwkv6_scan_bwd.cu``, recurrentgemma's local attention in the
  flash pair;
* the scan trace engine (``sim.jit_trace.precompute_trace_scan``, the
  large-n path of ``precompute_trace(engine="scan")``): a whole trace's
  TDM rounds in one launch of the float64 round-loop kernel of
  ``csrc/trace_scan.cu``, at ``examples/sim_scenarios.py --scale 1024``'s
  configuration (fading, Rayleigh gains only, 1024 nodes, 30 rounds), and
  train-on-trace through it (``train_cnn_on_traces(engine="scan")``) at
  256 nodes;
* pod-mode training of qwen2-vl-2b (``launch.train.train_loop``, the
  Mode A / Mode B steps of ``train.step``, AdamW of ``optim``, the
  checkpoint manager) at its published widths (28 layers, d_model 1536,
  12 q heads on 2 kv heads of 128, d_ff 8960, vocab 151 936, QKV bias,
  tied embeddings, a 256-position vision stub): Mode A at full depth,
  Mode B on 4 nodes cut to 4 layers, every attention's forward and
  backward in the flash kernels at D 128 with GQA 6:1, Mode B's gossip
  mix in the rows-mix kernel;
* activation checkpointing (``RunConfig.remat`` "full" and "dots",
  ``models.remat``) through the same train step: every family's step at
  the smoke widths under each policy, and qwen2-vl-2b's full-depth Mode A
  step with its whole 16 x 512 batch in one microbatch, each checkpointed
  unit's kernels launched again in its recompute.

Phases, each of which ends the run with a nonzero exit if it fails:

1. device   — a CUDA card of compute capability >= (9, 0); TF32 off for
              matmuls and cuDNN convolutions, so fp32 means fp32;
2. build    — nvcc builds every kernel from the sources into ``build/``
              (one nvcc per source, started together); each flash entry's
              registers and spill bytes from the ptxas report: no bf16
              instance of the forward or the backward may spill or have
              its wgmma serialised, and the six wgmma kernels of each
              must be there (forward: DP 64, 128, 256, each with and
              without the lse write; backward: dk / dv and dq at (DP,
              k-steps) (64, 4), (128, 5), (128, 8));
3. kernels  — each kernel against its plain torch version at the main
              paths' shapes and at edge shapes, its ValueError contracts,
              and its time beside its bound, plain and library times; the
              four kernels of the D-PSGD step also inside a CUDA graph
              (``graph_ms``: 100 captured calls), beside the library call
              captured the same way, and the host time of each piece of an
              eager rows-mix call, the earlier launch path and this one
              (3: gossip mixes, the q8 receive also with W whole at K of 1,
              6, 8 and 9 and a ragged N, waiting first and as the round
              launches it behind the send, timed in the round's variant,
              and the int8 round's chain in a
              CUDA graph of 100 rounds, the unfused sequence of device
              operations against this one's two launches, in turns, bit-
              equal outputs, us and operations per round;
              3b: flash and rglru, flash in bf16 also at
              the tensor-core kernel's tile edges, with its TFLOP/s over
              the band and share of the bound, and at the MLA and
              encoder-decoder shapes (D 192 with v 128, 16 heads of 64
              causal and not, T != S both ways) in bf16 and fp32, the
              served ones timed beside SDPA and their bound, rglru also
              at S across its chained scan's 32-step chunks, each time with its share of
              the bound and the scan's memset counted, 3c: rwkv6_scan,
              also in the served and a weak decay regime at the served
              shape and at S one short of and one past its 16-step chunk,
              and its state handoff to the one-token decode step, 3d: the
              int8 quantize / dequantize, bit-equal, in the TPU kernels'
              256-lane format through ``ops`` and the 2048-lane wire
              format, timed at the path's message and at (64, 1 048 576),
              with their launches in this phase; the int8 round's send
              bit-equal (q, scales, new residual) to its plain version and
              to the unfused sequence of launches at ragged lengths, one
              dead node, error feedback on and off, timed at the path's
              message;
              3e: flash_attention_bwd against its plain version (its
              sums in float64: the oracle), bf16 and fp32, at phase 16's
              shape (24, 512, 32, 80) causal, at
              phase 17's, windowed D 256 with 10 q heads on 1 kv head,
              non-causal T != S at D 64, D 192, ragged S and D 128: fp32
              2e-5, bf16 3e-2 and rows 2^-6; two calls bit-equal; each
              timed eagerly, on the device and in a CUDA graph beside its
              bound (5 products a pair), its plain version and SDPA's
              forward and backward (autograd));
              3f: rglru_scan_bwd and rwkv6_scan_bwd against their plain
              versions summed in float64 at phases 18/19's shapes, the
              forward rows' shapes and edges (S <= 32, ragged S, h0; s0
              and ds_final, u per batch row, D 8 to 128, the served decay
              regime), bar x max(1, max |oracle|) (1e-4, 5e-4), two calls
              bit-equal, timed beside their bound and plain versions
              (library: none);
4. slice    — the paper run, each λ target's 40 steps twice in turns:
              the eager body, then the entry point, whose step is a CUDA
              graph (steps/s of both); the gossip_mix launch counter must
              grow by one launch per graphed step; graphed against eager on
              the card in lockstep (losses 1e-4, parameters 1e-5); the
              first 5 steps rerun on the CPU (plain versions) from the
              card's state must agree on losses to 1e-4 and on the mixed
              parameters to 1e-5; the card's time per graphed step (CUDA
              events) and the profiler's busy time, each with its idle
              share;
5. compressed — 4 rounds of int8 error-feedback D-PSGD with one dead
              node; the send and gossip_mix_q8 counters must grow by the
              round count and quantize_int8 / dequantize_int8 not at all,
              and one more step must agree with the CPU (q bit-equal,
              parameters to 1e-5);
6. serving  — recurrentgemma-2b served at (4, 4096, 32) in bf16: tokens
              (4, 32), finite logits, exactly 8 flash and 576 rglru
              launches; prefill s, decode tok/s, peak memory, the decode
              idle share and the top device operations of a prefill;
7. served correctness — (a) fp32 teacher forcing at full width and depth
              (prefill and 3 decode steps against ``apply``, 2e-4);
              (b) card against CPU in lockstep at the smoke widths with
              window 32 (logits and caches, 1e-4);
8. serving rwkv6-7b — the same at (4, 4096, 32) in bf16: tokens (4, 32),
              finite logits, exactly 32 rwkv6_scan launches (one per
              layer in prefill, none in decode), and the same readings;
9. rwkv correctness — (a) as 7(a) for rwkv6-7b: the prefill against
              apply over the same prompt (same GEMM shapes) at 2e-4, the
              decode steps, which read the kernel's final state, at 2e-4
              plus 3x the floor that changing only the GEMMs' shapes
              moves apply's logits by (this model amplifies rounding; the
              state handoff itself is held in 3c); (b) card against CPU
              in lockstep at the smoke widths with 4 layers (5e-4, the
              rwkv6 kernel's bar);
10. simulated training — ``simulate_dpsgd_cnn`` over 60 000 / 10 000
              images with ``measure_compute=True`` (each round stamped with
              the card's own step time), each scenario twice in turns: with
              the step builders patched to their eager bodies (the "before"
              run, here only), then as the port runs it (CUDA graphs). In
              both runs: on ``compressed_int8`` the send and gossip_mix_q8
              counters each grow by exactly the round count and quantize,
              dequantize and gossip_mix not at all, on ``static`` gossip_mix
              does and the codec does not; each trace's communication
              fields equal the
              CPU simulator's charged the same compute; the first 5
              compressed rounds rerun on the CPU in lockstep (q bit-equal,
              losses 1e-4, parameters and residuals 1e-5 on every node row
              whose max-pools and ReLUs card and CPU route alike); rounds,
              simulated seconds, accuracy and host ms per round split into
              simulator, step and the rest, for both runs (the lockstep
              rounds are the graphed run's);
11. train-on-trace — ``train_cnn_on_traces`` at the same widths: (a) 4
              seeds of ``compressed_int8`` (after a warm-up at the family's
              width), the send and q8 counters each exactly 4 x 400, the
              rows mix and the codec 0, one graph signature, finite losses
              and parameters, accuracies in [0, 1], ``t_acc_s`` the
              traces' ``t_end_s`` at the eval rounds; (b) 2 seeds of
              ``fault_chaos``: the rows mix 2 x 400, rollbacks (2, 400, 6),
              crashes in play; (c) the loop at S = 1 against
              ``simulate_dpsgd_cnn`` on ``static`` and ``churn``, mean
              losses within 1e-5 over at least the first 8 rounds; (d) the
              first 5 family rounds of (a) rerun on the CPU in lockstep (q
              bit-equal, losses 1e-4, parameters and residuals 1e-5); (e)
              the round loop of (a) replayed under
              ``torch.cuda.set_sync_debug_mode("error")`` (finite
              losses; their distance from (a)'s printed, and one round
              replayed twice from the same inputs); (f) the family's
              wall seconds, host ms per round (per trace) against phase
              10's graphed driver, one replay's card time, the loop's idle
              share, graph captures and peak memory;
12. serving deepseek-v2-lite-16b — at (4, 4096, 32) in bf16: exactly 27
              flash launches (one per MLA layer in prefill, none in
              decode), a second serve from the same seed with identical
              tokens (the MoE combine uses no atomics), the readings of 6,
              the (token, expert) pairs each MoE layer's prefill drops
              at the config's capacity factor, and a decode step's
              time against the floor of reading every weight once;
13. deepseek correctness — (a) as 9(a), at capacity factor
              n_experts / top_k (drop-free: teacher forcing holds only
              where no pair is dropped); (b) card against CPU in lockstep
              at the smoke widths (1e-4);
14. serving seamless-m4t-large-v2 — at (4, 4096, 32) in bf16, the
              prompt as 2048 source frames and 2048 target tokens:
              exactly 36 flash launches (12 encoder, 12 decoder self, 12
              cross attention in prefill; none in decode), the readings
              of 6;
15. encoder-decoder correctness — (a) as 7(a), prompt 2048 over 2048
              source frames; (b) as 13(b);
16. training stablelm-3b — at full width (1 layer), 4 rounds of
              ``static`` after a one-round warm-up (the capture): exactly
              one flash forward and one backward a layer per round for all
              6 nodes, one rows mix per buffer of the mix (9 a round: the
              leaves in buffers of at most 2^24 lanes a node), one graph
              signature; the
              four masked mean losses finite, the first near ln 50 304;
              the accuracy; host ms per round, one replay's card ms, the
              loop's idle share, peak memory beside the prediction; then
              the per-round reference (``train_on_trace_reference``, after
              the family's graph is freed): losses 1e-4, parameters 1e-5;
17. training correctness — the smoke config in fp32, 3 rounds of
              ``static`` and of ``compressed_int8`` with per-leaf int8 (the
              send and q8 kernels once per leaf a round), every round's
              body rerun on the CPU from the card's inputs: losses 1e-4,
              parameters and residuals 1e-5;
18. training recurrentgemma-2b — as 16 with 3 nodes (the scenario's
              min_nodes) and batch 1: a round launches flash's forward
              and backward once, the RG-LRU scan's forward and backward
              twice (all nodes at once), 19 rows mixes; the first loss
              between ln V and ln V + sqrt(d_model) (a tied head);
19. training rwkv6-7b — as 18 with 1 layer and batch 4: the RWKV-6
              scan's forward and backward once a round (u per node, one
              per batch row), 14 rows mixes; the first loss near ln V;
20. recurrent training correctness — 17 for both archs' smoke configs
              (20a recurrentgemma-2b, 20b rwkv6-7b);
21. the scan trace engine — (a) the round-loop kernel against its plain
              version on the card and on the CPU, 2 rounds of static n 6,
              fading (shadowing 0) n 6, 64 and 256 with degrade renorm
              and naive, 70 packets (the second need word), no
              retransmission pass and 10 000 packets (past one tile):
              delivered, retx, w_eff and the counts (passes run, decodes
              decided) equal, times within 1e-12 relative, any decode
              that differs printed with its |cap - rate| / rate, the
              decodes on the filter's exact path printed; the same for
              stablelm-3b's phase 16 cut (~329 000 packets) through
              ``precompute_trace(engine="scan")`` on ``static`` (phase
              16's scenario) and ``fading``, with its µs a pass; the
              filter's decision (``trace_decide``) at every intended
              pair of fading n 6 and 64, at the band's edges, inside it
              and at uniform draws, equal to the exact code's; (b)
              --scale at n = 1024: the certified plan
              once on the host, then ``precompute_trace_scan`` over 30
              rounds with sim= (one launch), the example's line, the
              call's ms (CUDA events), the kernel's device ms, the passes
              and decodes (and those on the exact path), set-up,
              copy-out and host epilogue seconds,
              rounds/s, peak memory; its first 2 rounds held against the
              plain version on the card; (c) ``train_cnn_on_traces`` over 2
              fading seeds at n = 256 with engine="scan", 50 images a node
              (2 rounds): the round loop launched once a seed, the rows
              mix every round at W (256 x 256), every round rerun on the
              CPU in lockstep (losses 1e-4, parameters 1e-5); the rows mix
              at W (256 x 256) x (256 x 21 840) fp32 timed beside
              ``torch.matmul``, eager and in a graph;
22. pod-mode training — qwen2-vl-2b at 4 nodes x batch 4 x 512 tokens:
              (a) Mode A at full depth through ``train_loop`` (eager: a
              graph's three copies of the state do not fit), 2 warm-up
              and 6 timed steps, 28 flash forwards and backwards a step,
              no rows mix, the first loss near ln V, ms a step, tokens/s,
              peak memory, one step's CUDA-event and profiler times,
              idle share and largest device operations; (b) Mode B cut
              to 4 layers: ``train_loop`` with the controller's plan (the
              node mean), then ``make_train_step`` on ring-1 with
              compression none and int8 (one rows mix per buffer group a
              step, flash once a layer for all nodes), its SGD step held
              against ``core.dpsgd.dpsgd_step`` with ``plan_w`` (rtol
              2e-4, atol 2e-5), eager against graphed in turns at 1
              layer; (c) the smoke widths card (a CUDA graph) against CPU
              in lockstep: Mode A and Mode B with AdamW, Mode B none,
              bf16, int8 and microbatch 2 with SGD (losses 1e-4,
              parameters and residuals 1e-5; where AdamW's steps lr
              m^ / (sqrt(v^) + eps) from the card's and the CPU's own
              moments differ by more than 5e-6, the parameters within
              1e-5 of that difference, the largest printed with its
              gradients; the optimizer's leaves 1e-5 of their leaf's
              max |x|); the
              fault drill (node 2 at step 3) card against CPU from one
              step-0 checkpoint; a checkpoint at step 2 with a
              ``resume=True`` restart whose steps 3-4 repeat the
              uninterrupted losses (bit-equality printed); (c')
              ``train_loop`` at the smoke widths eager against graphed
              in turns (ms a step, where a graph fits); phase 3e
              times flash's forward and backward at this shape;
23. activation checkpointing — (a) one Mode A step (SGD) per remat
              policy from one state at the smoke widths for qwen2-vl-2b,
              gemma3-12b, recurrentgemma-2b, rwkv6-7b, deepseek-v2-lite-16b
              and seamless-m4t-large-v2 (3 layers where the smoke config
              has fewer), and a Mode B ring-1 step of qwen2-vl-2b under
              vmap: full and dots against none (losses 1e-4, parameters
              1e-5), the launch counters exactly none's with, under
              full, every forward kernel call of a checkpointed unit made
              once more (the recompute) and the backward kernels
              unchanged; (b) qwen2-vl-2b at full depth and width, Mode A,
              AdamW, 16 x 512 tokens: full against none at 4
              microbatches, one step from one state (losses 1e-4,
              parameters 1e-5 or, where the two AdamW steps split, 1e-5
              of their difference), then none at 4 microbatches, full at
              1 and dots at ``REMAT_MICROBATCH["dots"]`` in turns: ms a
              step, tokens/s, peak memory, launches a step, one step's
              CUDA-event and profiler times, idle share and largest
              device operations; (c) Mode B at 4 layers (the
              controller's plan), none against full in turns, ms a step
              and peak memory;
24. inspection tooling — the dry run (``launch.dryrun``: the step on
              data-free tensors through the kernels' shape rules, with
              the card and then the CPU as the fake device, which must
              agree) of each configuration phases 8, 12 and 23 read:
              qwen2-vl-2b's full-depth Mode A step under remat full x 1
              and none x 4, its Mode B step at 4 layers, rwkv6-7b's and
              deepseek-v2-lite-16b's serve; each dry-run peak (offset by
              what the card held beyond the step's own state at the
              reset) within 10 % of the card's max_memory_allocated, its
              kernel launches equal to the wrappers' counters, and the
              launches ``utils.profile`` reads from the kernel names of
              phase 23 (b)'s and the serves' profiler traces equal to
              them too.
25. the node axis over a torch.distributed world (``launch.mesh``,
              ``train.shardings``, ``core.gossip``'s execution half,
              ``train.step``'s Mode B over a fleet, ``sim.batch``'s
              mesh): (a) a world of one rank under NCCL runs
              ``launch.train.train_loop`` at 22 (c)'s smoke widths (the
              controller's ring-1, none and int8) and phase 17's smoke
              family through ``train_model_on_traces(mesh=...)``, each
              bit-equal to the one-device run with the same launches;
              (b) each rank's receive of a four-rank ring emulated in one
              process, through the port's receive halves
              (``core.gossip.mix_received``, ``core.compression.
              receive_q8``, ``core.dpsgd.receive_q8_block`` /
              ``receive_bf16_block``) against plan_w @ X and the plain
              versions; (c) with four cards only, worlds of 4, 2 and 3
              ranks under torchrun (this script with ``--fleet-rank``,
              and ``repro_torch.sim.real_model_smoke``): the fleet's
              gossip against plan_w @ X, qwen2-vl-2b's Mode B at full
              depth one node a card (ms a step, tokens/s, peak GiB a
              rank, P2P bytes equal to ``utils.collectives``' reckoning)
              and its state's whole node axis gathered to rank 0's host
              and scattered back (a checkpoint's and the fault drill's
              move), the real-model smoke at fleet 2, stablelm-3b's
              compressed_int8 family at 1 layer on 6 nodes over 3 ranks,
              and the fleet's Mode B step captured as a CUDA graph
              (replay bit-equal to eager) with ``train_loop`` over the
              fleet: checkpoint, resume and the fault drill. On one card
              (c) prints that it was not run.
28. serving under tensor parallelism (``launch.serve.generate(tp=)``,
              ``train.shardings.cache_layout``, the q head split of
              ``models.attention.head_layout``): (a) on one card every
              served family's smoke serve (prefill and 3 decode steps)
              through the tensor-parallel code on a (1, 1) world,
              bit-equal to one-device serving with the same launches;
              ``repro_torch.examples.serve_demo`` on the card;
              flash at the rank's heads of (b)'s serves (recurrentgemma-2b
              with its 10 q heads gathered whole) and the scans at the
              rank's channels / heads, against their plain versions; the
              dry run's tp4 cell of phi3.5-moe-42b-a6.6b's serve in
              torch's fake process group; (b) with four cards only,
              phi3.5-moe-42b-a6.6b at full width and all 32 layers over
              them (prefill s, tok/s, ms a decode step, idle, collectives
              a step, peak a rank, every rank's tokens equal), every
              served arch at full width and a cut depth teacher-forced in
              fp32 against each rank's card alone (phases 9 and 13's
              bars), the q head split's smoke training against the card
              alone (1e-5), and the dry run's peak within 10 % of rank
              0's max_memory_allocated. On one card (b) prints that it
              was not run.

The cost model (``kernels.cost``: every bound) and the profiler summary
(``utils.profile``) are the package's; this script keeps no copy.
Each phase prints its wall time. The last lines are the card's
``nvidia-smi`` name and power limit, one JSON line with every kernel's
numbers (quantize_int8 and dequantize_int8, off the int8 round now,
count 0 launches there and phase 3d's checks under ``check_launches``;
flash's ``launches`` are phase 6's, its ``launches_by_path`` add phases
12, 14, 16 and 18, and its ``mla``, ``cross`` and ``decoder`` keys time the
new prefill shapes; flash_attention_bwd's are phase 16's, its
``library_ms`` SDPA's backward, ``library_device_ms`` that call's
device time and ``library_fwd_ms`` SDPA's forward; rglru_scan_bwd's and
rwkv6_scan_bwd's are phases 18's and 19's, their ``prefill`` keys time
the forward rows' shapes; gossip_mix's ``w256`` times the rows mix at
phase 21 (c)'s W; trace_scan's are phase 21 (b)'s, its ``plain_ms`` the
plain version's over the first 2 rounds, beside the kernel's
``ms_held_rounds``, its ``long_traces`` phase 21 (a)'s stablelm-3b cut,
its ``decide_check`` the decision check's counts; flash's and its
backward's ``qwen2_vl_train`` time phase 22's shape and their
``launches_by_path`` and gossip_mix's add phase 22's runs; flash's, the
scans' and their backwards' ``launches_by_path`` add phase 23's steps),
and ``{"ok": true,
"device": ...}``. The smoke sets
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` unless the caller set
it.

Run from the repository root:  python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# the port's cost model (repro_torch.kernels.cost) and profiler summary
# (repro_torch.utils.profile), imported by main() once src/ is on the path
cost = prof = None

N_NODES = 6
EPS = 5.0
N_TRAIN, N_TEST = 60_000, 10_000     # SyntheticFashion's paper defaults
STEPS = 40                           # D-PSGD steps per λ target
CPU_STEPS = 5                        # steps rerun on the CPU
PROFILE_STEPS = 10                   # steps under the profiler
STEADY_STEPS = 200                   # graphed steps past the first replays
TIMING_REPEATS = 3                   # eager / graphed pairs per λ target
COMPRESSED_ROUNDS = 4
TOL_FP32, TOL_BF16 = 1e-5, 3e-2      # tests/test_kernels.py
TOL_FLASH_FP32, TOL_RGLRU = 2e-5, 1e-4   # tests/test_kernels.py
TOL_RWKV = 5e-4                          # tests/test_kernels.py
# bf16 flash, besides max|err| <= TOL_BF16: every output row (one query,
# one head: D values) within 2^-6 of its norm, ||got - want|| <=
# TOL_FLASH_ROW ||want||. Rows that attend to 2048 keys are ~0.036 in size,
# so the absolute bar alone would pass a kernel that loses a few keys of
# the window's edge; losing one key of 2048 moves a row by ~2048^-1/2 =
# 0.022 of its norm, while the kernel's own roundings (P and out to bf16)
# stay well below the bar (PERF.md, PR 15's row of the flash kernel).
TOL_FLASH_ROW = 2.0 ** -6
# the forward's fp32 log-sum-exp of a row against the plain version's
# (torch.logsumexp of the same fp32 scores): rows of ~512 keys, lse ~7
TOL_LSE = 1e-5

# the serving slice (phases 6-7): recurrentgemma-2b at its published widths
SERVE_ARCH = "recurrentgemma-2b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4096, 32
WARM_PROMPT = 256                    # warm-up generate, same widths
DECODE_PROFILE_STEPS = 10
TF_PROMPT, TF_STEPS = 4096, 3        # 7(a): teacher forcing, batch 1, fp32
LOCK_BATCH, LOCK_PROMPT, LOCK_STEPS = 2, 80, 4   # 7(b): card vs CPU

# flash at the MLA and encoder-decoder slice's shapes (phase 3b): (B, S, T,
# H, D, Dv, causal); held against the plain version in bf16 and fp32, and
# the served prefill shapes timed in bf16
NEW_FLASH_TIMED = {
    "mla": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 16, 192, 128, True),
    "cross": (SERVE_BATCH, SERVE_PROMPT // 2, SERVE_PROMPT // 2, 16, 64, 64,
              False),
    "decoder": (SERVE_BATCH, SERVE_PROMPT // 2, SERVE_PROMPT // 2, 16, 64,
                64, True)}
NEW_FLASH_CASES = [*NEW_FLASH_TIMED.values(),
                   (2, 33, 100, 16, 64, 64, False),
                   (2, 100, 33, 16, 64, 64, False),
                   (1, 300, 300, 16, 192, 128, True),
                   (2, 129, 700, 4, 64, 64, False)]

# the MLA + MoE and encoder-decoder slice (phases 12-15): the same prompt,
# batch and tokens; 13(b) and 15(b) at the smoke widths, held at the
# serving tests' cache bar
MLA_ARCH = "deepseek-v2-lite-16b"
ENCDEC_ARCH = "seamless-m4t-large-v2"
LOCK_TOL = 1e-4

# the rwkv slice (phases 8-9): rwkv6-7b at its published widths, the same
# prompt, batch and tokens; 9(b) at the smoke widths with 4 layers
RWKV_ARCH = "rwkv6-7b"
RWKV_CHUNK = 32                      # the model's chunk: the plain version's
LOCK_RWKV_LAYERS = 4

# training through the wireless simulator (phase 10): one epoch of the
# paper's setup (400 rounds of batch 25 on 6 nodes) per scenario
SIM_EPOCHS = 1
SIM_CPU_ROUNDS = 5                   # compressed rounds rerun on the CPU

# train-on-trace (phase 11): families of the same epoch over precomputed
# traces, one graph replay per round for the family
FAMILY_INT8 = 4                      # (a) compressed_int8 seeds
FAMILY_CHAOS = 2                     # (b) fault_chaos seeds, watchdog armed
PARITY_ROUNDS = 8                    # (c) first rounds held within 1e-5
FAMILY_CPU_ROUNDS = 5                # (d) family rounds rerun on the CPU


# training stablelm-3b on wireless traces (phases 3e, 16, 17): its
# published widths at a depth of 1 layer (6 fp32 replicas of its 32 layers
# are 67 GB before any gradient; 1 layer is 1.35 GB a replica), batch 4 of
# 512 tokens a node, the static scenario (6 nodes), 4 rounds; 17 at the
# smoke widths, 3 rounds of static and of per-leaf int8
TRAIN_ARCH = "stablelm-3b"
TRAIN_LAYERS = 1
TRAIN_BATCH, TRAIN_SEQ, TRAIN_EVAL_BATCH = 4, 512, 8
TRAIN_ROUNDS = 4
# predicted before the run (PERF.md): 45.542 GiB less the initial
# parameters, the round's input copy and three snapshots the loop no
# longer holds
TRAIN_PEAK_GIB = (30.0, 38.0)
LOCK_TRAIN_SEQ, LOCK_TRAIN_ROUNDS = 32, 3
# the backward kernel at phase 16's shape: 6 nodes x batch 4 folded into B
BWD_MAIN = (N_NODES * TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 32, 80, True, 0)

# training the recurrent archs on wireless traces (phases 3f, 18-20): the
# published widths at a depth of one pattern unit (recurrentgemma-2b:
# rglru, rglru, local; rwkv6-7b: 1 layer), the static scenario with its 6
# nodes cut to 3 (the scenario's min_nodes: the 256 000- and 65 536-token
# embeddings make 6 replicas too many), 512 tokens, 4 rounds; 20 at the
# smoke widths, 3 rounds of static and of per-leaf int8
# recurrentgemma-2b's batch was cut from 2 to 1 a node: at 2 its capture
# ran out of the card's 80 GB (the (3, 2, 512, 256 000) logits' chain and
# the tied embedding's table-sized gradients fill the graph's pool;
# PERF.md)
REC_NODES = 3
REC_TRAIN = {   # arch: (layers, batch a node, predicted peak GiB range)
    "recurrentgemma-2b": (3, 1, (55.0, 65.0)),
    "rwkv6-7b": (1, 4, (43.0, 49.0)),
}
# phase 3f: the backward kernels at phases 18/19's shapes (nodes x batch
# folded into B), at the forward rows' shapes, then edges
RGLRU_BWD_MAIN = (REC_NODES * REC_TRAIN["recurrentgemma-2b"][1], TRAIN_SEQ,
                  2560)
RWKV_BWD_MAIN = (REC_NODES * REC_TRAIN["rwkv6-7b"][1], TRAIN_SEQ, 64, 64)

# the scan trace engine (phase 21): (a) the round loop's kernel against its
# plain version on the card and on the CPU, TRACE_HELD_ROUNDS rounds of
# each case; (b) examples/sim_scenarios.py --scale's configuration, fading
# with Rayleigh gains only, TRACE_N nodes and TRACE_ROUNDS rounds, its first
# TRACE_HELD_ROUNDS held against the plain version on the card; (c) a
# train-on-trace family of TRACE_SEEDS fading seeds at TRACE_TRAIN_N nodes
# through the scan engine, TRACE_PER_NODE images a node (2 batches of 25:
# 2 rounds), every round rerun on the CPU in lockstep
TRACE_N, TRACE_ROUNDS, TRACE_HELD_ROUNDS = 1024, 30, 2
TRACE_TRAIN_N, TRACE_SEEDS, TRACE_PER_NODE = 256, 2, 50
NO_SHADOW = {"fading.shadowing_sigma_db": 0.0}
TRACE_CASES = [      # (scenario, n, overrides, degrade modes)
    ("static", 6, {}, ("renorm",)),
    ("fading", 6, {}, ("renorm", "naive")),
    ("fading", 64, {}, ("renorm", "naive")),
    ("fading", 256, {}, ("renorm", "naive")),
    ("fading", 6, {"model_bits": 70 * 32768.0 - 100}, ("renorm",)),  # P 70
    ("fading", 64, {"mac.max_retx_rounds": 0}, ("renorm",)),
    # P 10 000: past one tile, and past the earlier whole-trace shared
    # memory layout's cap (8 640 packets at n = 6)
    ("fading", 6, {"model_bits": 10_000 * 32768.0 - 100}, ("renorm",))]
# (a) also: TRAIN_ARCH's phase 16 cut (TRAIN_LAYERS layers, ~329 000
# packets) through precompute_trace(engine="scan"), on phase 16's scenario
# and on fading at the same packet count; the filter's decision check at
# every intended pair of fading at these n
TRACE_LONG_SCENARIOS = ("static", "fading")
TRACE_DECIDE_N = (6, 64)
TOL_TIME = 1e-12                     # relative: the running sum's association

# pod-mode training (phase 22): qwen2-vl-2b (the pod trainer's default arch)
# at its published widths, 4 nodes x batch 4 x 512 tokens (the sequence
# must exceed the vision stub's 256 patch positions); (a) Mode A at full
# depth, POD_WARM steps then POD_TIMED timed, eager (a graph would hold
# three copies of the 18.5 GB state), POD_A_MICROBATCH microbatches; (b)
# Mode B cut to POD_B_LAYERS of 28 layers (four fp32 replicas with AdamW's
# moments at full depth are 74 GB before any gradient), and eager against
# graphed in turns at POD_GRAPH_LAYERS; (c) the smoke widths card against
# CPU in lockstep
POD_ARCH = "qwen2-vl-2b"
POD_NODES, POD_BATCH, POD_SEQ = 4, 4, 512
# (a) accumulates its gradient over 4 microbatches of 4 sequences: the
# whole batch's saved activations (~110 KB a token a layer, 93.6 MB of
# bf16 weight casts a layer, ~620 KB a token around the logits) beside
# the 18.5 GB state ran out of the card (76.4 GiB allocated in the
# backward), and 2 microbatches peaked at 77.0 GiB of its 79.2 (PERF.md)
POD_A_MICROBATCH = 4
POD_WARM, POD_TIMED = 2, 6
POD_B_LAYERS, POD_GRAPH_LAYERS, POD_PAIRS = 4, 1, 3
POD_LOCK_STEPS, POD_LOCK_BATCH, POD_LOCK_SEQ = 3, 2, 32
POD_LOCK_ETA = 1e-3      # AdamW's lr in (c)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.95, 1e-8   # optim.make_optimizer's
# predicted before the run (PERF.md): (a) 2 microbatches read 77.0 GiB,
# 4 save half the activations; (b) 20.2 GB of state at 4 layers, ~12
# saved, its gradient, mix and AdamW's new state
POD_PEAK_GIB = {"a": (62.0, 72.0), "b": (45.0, 66.0)}
# flash at qwen2-vl's training shape: 4 nodes x batch 4 folded into B,
# 12 q heads on 2 kv heads of 128, causal (phase 3e)
QWEN_BWD = (POD_NODES * POD_BATCH, POD_SEQ, POD_SEQ, 12, 2, 128, True, 0)

# activation checkpointing (phase 23): (a) one Mode A step per remat
# policy from one state for a family of each kind at the smoke widths
# (qwen2-vl-2b, rwkv6-7b and deepseek-v2-lite-16b deepened to 3 layers, as
# tests/test_torch_remat.py, so that several units are checkpointed), SGD
# so that the parameters carry the gradients' differences unamplified;
# (b) qwen2-vl-2b's full-depth Mode A step at 16 x 512 tokens, AdamW, at
# each policy's fewest microbatches that fit ("none": 1 and 2 ran out of
# the card in phase 22; "dots": found on the card, PERF.md), in turns;
# (c) Mode B at 4 layers, none against full
REMAT_ARCHS = ("qwen2-vl-2b", "gemma3-12b", "recurrentgemma-2b", "rwkv6-7b",
               "deepseek-v2-lite-16b", "seamless-m4t-large-v2")
REMAT_DEEPER = {"qwen2-vl-2b": 3, "rwkv6-7b": 3, "deepseek-v2-lite-16b": 3}
REMAT_BATCH, REMAT_SEQ = 4, 64
REMAT_MICROBATCH = {"none": POD_A_MICROBATCH, "full": 1, "dots": 1}
REMAT_TURNS = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else f"nvidia-smi failed: {out.stderr.strip()}"


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps: int = 100, rounds: int = 5,
            warmup: int = 10) -> float:
    """CUDA events around ``reps`` back-to-back calls, after ``warmup``
    calls; the median over ``rounds`` of the per-call mean."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def paired_ms(torch, fn, library, reps: int = 100,
              rounds: int = 9) -> tuple[float, float]:
    """``time_ms`` of a kernel's eager call and of its library call, taken
    in turns (kernel, library, library, kernel, ...) so that a stall of the
    shared host falls on both alike: the median per call of each."""
    for f in (fn, library):
        for _ in range(10):
            f()
    torch.cuda.synchronize()
    per_call = ([], [])
    for i in range(rounds):
        order = (0, 1) if i % 2 == 0 else (1, 0)
        for j in order:
            f = (fn, library)[j]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                f()
            end.record()
            end.synchronize()
            per_call[j].append(start.elapsed_time(end) / reps)
    return statistics.median(per_call[0]), statistics.median(per_call[1])


def graph_ms(torch, fn, reps: int = 100, rounds: int = 5) -> float:
    """``reps`` back-to-back calls of ``fn`` captured into one CUDA graph
    (after warm-up calls on the capture's side stream), the graph replayed
    ``rounds`` times between CUDA events: the median per call. What a call
    costs inside the D-PSGD step's graph, with no host dispatch. Captures
    on the port's one capture stream (a new stream per capture would leave
    a cuBLAS workspace behind for each)."""
    from repro_torch import graphs

    side = graphs._side_stream(torch.device("cuda", 0))
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_ulp_excess(torch, got, want, tol: float) -> int:
    """Elements of ``got`` farther from ``want`` than ``tol`` or one bf16
    ulp of ``want``'s value, whichever is larger (the ulp at |x| in
    [2^e, 2^(e+1)) is 2^(e-7))."""
    w = want.double()
    mag = w.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    bar = torch.clamp(ulp, min=tol)
    return int(((got.double() - w).abs() > bar).sum())


def row_err(a, b) -> float:
    """Largest relative error over the rows of the last axis:
    max ||a_r - b_r|| / ||b_r||."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30))
                 .max())


def flash_edge_tile_dropped(torch, q, k, v, window: int):
    """A planted wrong bf16 flash kernel, causal with a window: where the
    window clips a 128-row query tile's band, the band starts one 64-key
    tile late (the partial tile at the window's edge is lost). Otherwise
    the plain version's arithmetic; rows left with no key read 0."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, s, hkv, hq // hkv, d) * d**-0.5
    out = torch.zeros_like(q)
    for q0 in range(0, s, 128):
        q1 = min(q0 + 128, s)
        lo = max(0, q0 - window + 1) // 64 * 64 \
            + (64 if q0 - window + 1 > 0 else 0)
        if lo >= q1:
            continue
        scores = torch.einsum("bshgd,bthd->bshgt", qf[:, q0:q1],
                              k[:, lo:q1].float())
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(lo, q1, device=q.device)[None, :]
        live = ((kpos <= qpos) & (qpos - kpos < window))[None, :, None, None]
        p = torch.softmax(scores.masked_fill(~live, -1e30), dim=-1) \
            * live.any(-1, keepdim=True)
        o = torch.einsum("bshgt,bthd->bshgd", p, v[:, lo:q1].float())
        out[:, q0:q1] = o.reshape(b, q1 - q0, hq, d).to(q.dtype)
    return out


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def tapped(family_step, tap, keep_args: bool = False):
    """``sim.batch._family_step`` with ``tap(step, args, out)`` called after
    every round the family loop runs (the loop stages a round's inputs,
    then runs it: ``GraphedStep.stage``). ``args`` is None unless
    ``keep_args``: kept, it holds the round's inputs alive."""
    def make(*key):
        step = family_step(*key)

        class Tapped:
            def stage(self, *args):
                run, kept = step.stage(*args), args if keep_args else None

                def go():
                    out = run()
                    tap(step, kept, out)
                    return out
                return go

            def __call__(self, *args):
                return self.stage(*args)()
        return Tapped()
    return make


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(torch) -> None:
    phase("1. device")
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} | capability {cap} | "
          f"{torch.cuda.device_count()} device(s)")
    check(cap >= (9, 0), f"capability {cap} < (9, 0): the kernels are sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")


def flash_label(entry: str) -> str:
    """A flash kernel's mangled name as ``name<args>``: its template
    arguments (DP, the lse write, the element type) in order."""
    m = re.search(r"(?<=\d)(flash_\w+?_kernel)(?:I(.*?)E)?E?v", entry) or \
        re.search(r"(?<=\d)(flash_\w+?_kernel)()", entry)
    if not m:
        return entry
    args = []
    for dp, lse, bf16, f32 in re.findall(
            r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16)|(f)", m[2] or ""):
        args += [dp] if dp else ["lse"] if lse == "1" else [] if lse else \
            ["bf16"] if bf16 else ["f32"] if f32 else []
    return f"{m[1]}<{', '.join(args)}>" if args else m[1]


def phase_build() -> None:
    phase("2. build")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()          # one nvcc per missing source, together
    print(f"built {built or 'nothing (all up to date)'} in "
          f"{time.perf_counter() - t0:.2f}s")
    for name in _build.SOURCES:
        _, so = _build._target(name)
        _build.load(name)
        print(f"{name}: {so.relative_to(ROOT)}")
        log = so.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        if name not in ("flash_attention", "flash_attention_bwd"):
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    print(f"   {line.strip()}")
            continue
        # the flash entries by name: no bf16 kernel may spill, and the
        # wgmma ones must be all there (the forward's six instances; the
        # backward's dk / dv and dq at (DP, KS) (64, 4), (128, 5), (128, 8))
        bf16, wgmma = [], []
        for entry, regs, st, ld in _build.ptxas_entries(text):
            label = flash_label(entry)
            print(f"   {label}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B")
            if "bf16" in entry or "bfloat16" in entry:
                bf16.append((label, st + ld))
            if "_bf16_kernel" in entry and "rows" not in entry:
                wgmma.append(label)
        for line in text.splitlines():
            if "Performance Loss" in line:      # wgmma serialised by ptxas
                print(f"   {line.strip()}")
        want = 6
        check(len(wgmma) == want, f"ptxas log of {name} names {len(wgmma)} "
              f"bf16 wgmma kernels, expected {want}: {wgmma}")
        check(all(n == 0 for _, n in bf16),
              f"bf16 kernels of {name} spill: {bf16}")
        check("Performance Loss" not in text,
              f"ptxas serialised wgmma in {name}")


def phase_kernels(torch) -> dict:
    phase("3. kernels against their plain versions")
    from repro_torch.core.compression import quantize_int8_rows
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import quantize as qz

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def softmax_rows(m, k):
        return torch.softmax(torch.randn((m, k), generator=gen), -1).to(dev)

    errs = {"gossip_mix": 0.0, "gossip_mix_q8": 0.0}

    def hold(name, got, want, tol, what):
        e = err(got, want)
        print(f"{name:14s} {what:44s} max|err| {e:.3e} (tol {tol:g})")
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} {what}: {got.shape}/{got.dtype} vs "
              f"{want.shape}/{want.dtype}")
        check(e <= tol, f"{name} {what}: max|err| {e} > {tol}")
        errs[name] = max(errs[name], e)

    # gossip_mix: the TPU signature (M = 1) and the rows form
    for k, n in ((7, 21_840), (9, 3 * 8192 + 5)):
        for dtype, tol in ((torch.float32, TOL_FP32),
                           (torch.bfloat16, TOL_BF16)):
            bufs = randn(k, n).to(dtype)
            w = softmax_rows(1, k)[0]
            hold("gossip_mix", gm.gossip_mix(bufs, w),
                 gm.gossip_mix_rows_plain(w[None], bufs)[0], tol,
                 f"(K={k}, N={n}) {str(dtype)[6:]}")
    for m, k, n in ((N_NODES, N_NODES, 21_840), (N_NODES, 2 * N_NODES, 21_840),
                    (3, 5, 8195)):
        for dtype, tol in ((torch.float32, TOL_FP32),
                           (torch.bfloat16, TOL_BF16)):
            bufs, w = randn(k, n).to(dtype), softmax_rows(m, k)
            hold("gossip_mix", gm.gossip_mix_rows(w, bufs),
                 gm.gossip_mix_rows_plain(w, bufs), tol,
                 f"rows W ({m}x{k}) bufs ({k}x{n}) {str(dtype)[6:]}")
    # a contiguous view 4 bytes off 16-byte alignment: the scalar path
    k, n = 5, 4096
    store = randn(k * n + 1)
    bufs, w = store[1:].view(k, n), softmax_rows(2, k)
    hold("gossip_mix", gm.gossip_mix_rows(w, bufs),
         gm.gossip_mix_rows_plain(w, bufs), TOL_FP32,
         f"rows ({k}x{n}) misaligned view fp32")

    # gossip_mix_q8: the TPU signature and the D-PSGD rows form
    for k, n in ((5, 21_840), (3, 3 * 8192 + 5)):
        q, s = quantize_int8_rows(randn(k, n, scale=4.0))
        x, w = randn(n), softmax_rows(1, k + 1)[0]
        hold("gossip_mix_q8", gm.gossip_mix_q8(x, q, s, w),
             gm.gossip_mix_q8_rows_plain(w[:1], w[None, 1:], x[None], q, s)[0],
             TOL_FP32, f"(K={k}, N={n}, Np={q.shape[1]})")
    n = 21_840
    q, s = quantize_int8_rows(randn(N_NODES, n, scale=0.3))
    x, wfull = randn(N_NODES, n, scale=0.3), softmax_rows(N_NODES, N_NODES)
    w_self = torch.diagonal(wfull).contiguous()
    w_off = wfull - torch.diag(w_self)
    hold("gossip_mix_q8", gm.gossip_mix_q8_rows(w_self, w_off, x, q, s),
         gm.gossip_mix_q8_rows_plain(w_self, w_off, x, q, s), TOL_FP32,
         f"rows n={N_NODES} (N={n}, Np={q.shape[1]})")
    # the int8 round's receive, W taken whole: the path's shape, a ragged
    # N, and K one payload, a whole group of 8 and one past it; each
    # waiting first, and as the round launches it (right behind the send,
    # W and flat loaded ahead of the wait, one dead node), against the
    # plain receive of the same q and scales
    for k, n in ((N_NODES, 21_840), (N_NODES, 21_843), (1, 21_840),
                 (8, 21_840), (9, 21_840), (9, 8195)):
        q, s = quantize_int8_rows(randn(k, n, scale=0.3))
        x, wfull = randn(k, n, scale=0.3), softmax_rows(k, k)
        hold("gossip_mix_q8", gm.gossip_mix_q8_w(wfull, x, q, s),
             gm.gossip_mix_q8_w_plain(wfull, x, q, s), TOL_FP32,
             f"W whole ({k}x{k}) (N={n}, Np={q.shape[1]})")
        res = randn(k, n, scale=1e-3)
        live = torch.arange(k, device=dev) != k - 1
        mixed, _ = gm.gossip_mix_int8_round(x, res, wfull, live)
        q, s, _ = qz.quantize_int8_ef(x, res, live)
        hold("gossip_mix_q8", mixed, gm.gossip_mix_q8_w_plain(wfull, x, q, s),
             TOL_FP32, f"the round's ({k}x{k}) (N={n}, Np={q.shape[1]})")

    # the ValueError contracts of repro/kernels/gossip_mix.py:143-153
    qz = torch.zeros((2, 4096), dtype=torch.int8, device=dev)
    for what, args, match in (
            ("weights", (torch.zeros(100, device=dev), qz,
                         torch.ones((2, 2), device=dev),
                         torch.ones(4, device=dev) / 4), "weights"),
            ("ragged scales", (torch.zeros(100, device=dev), qz,
                               torch.ones((2, 3), device=dev),
                               torch.ones(3, device=dev) / 3), "scale"),
            ("short payload", (torch.zeros(9000, device=dev), qz,
                               torch.ones((2, 2), device=dev),
                               torch.ones(3, device=dev) / 3), "shorter")):
        before = gm.gossip_mix_q8_rows.launches
        try:
            gm.gossip_mix_q8(*args)
        except ValueError as e:
            check(match in str(e), f"q8 {what}: wrong message {e}")
            check(gm.gossip_mix_q8_rows.launches == before,
                  f"q8 {what}: launched before raising")
            print(f"gossip_mix_q8  ValueError on {what}: ok")
        else:
            fail(f"gossip_mix_q8 accepted a bad {what} on CUDA tensors")
    torch.cuda.synchronize()

    # times at the main path's shapes: "ms" the eager wrapper call, "graph_ms"
    # the call inside a CUDA graph (as the step replays it), each beside the
    # one-call library equivalent timed the same way
    m = k = N_NODES
    n = 21_840
    bufs, w = randn(k, n), softmax_rows(m, k)
    b_ms, b_by = cost.bound(*cost.rows_cost(m, k, n, 4))
    eager_ms, library_ms = paired_ms(
        torch, lambda: gm.gossip_mix_rows(w, bufs),
        lambda: torch.matmul(w, bufs))
    mix = {"ms": eager_ms,
           "plain_ms": time_ms(torch,
                               lambda: gm.gossip_mix_rows_plain(w, bufs)),
           "library_ms": library_ms,
           "graph_ms": graph_ms(torch, lambda: gm.gossip_mix_rows(w, bufs)),
           "library_graph_ms": graph_ms(torch, lambda: torch.matmul(w, bufs)),
           "device_ms": prof.device_ms(lambda: gm.gossip_mix_rows(w, bufs),
                                  "gossip_mix_rows"),
           "bound_ms": b_ms, "bound_by": b_by,
           "shape": f"W ({m}x{k}) fp32, bufs ({k}x{n}) fp32"}
    q, s = quantize_int8_rows(randn(k, n, scale=0.3))
    x = randn(m, n, scale=0.3)
    b_ms, b_by = cost.bound(*cost.q8_cost(m, k, n))

    def receive():
        # the variant the round launches: W and self loaded ahead of the
        # wait (each call here waits on the one before, which writes
        # neither)
        return gm.gossip_mix_q8_w(w, x, q, s, after_send=True)
    q8 = {"ms": time_ms(torch, receive),
          "plain_ms": time_ms(torch, lambda: gm.gossip_mix_q8_w_plain(
              w, x, q, s)),
          "library_ms": None,
          "graph_ms": graph_ms(torch, receive),
          "library_graph_ms": None,
          "device_ms": prof.device_ms(receive, "gossip_mix_q8_rows_kernel"),
          "bound_ms": b_ms, "bound_by": b_by,
          "shape": f"W ({m}x{k}) whole, self ({m}x{n}) fp32, q "
                   f"({k}x{q.shape[1]}) int8, the round's variant (W and "
                   f"self loaded ahead of the wait)"}
    for name, t in (("gossip_mix", mix), ("gossip_mix_q8", q8)):
        print_times(name, t)
    against_library("gossip_mix", mix, "torch.matmul")
    launch_path(torch, w, bufs)
    int8_round_chain(torch, randn, softmax_rows)
    mix["max_abs_err"], q8["max_abs_err"] = errs["gossip_mix"], \
        errs["gossip_mix_q8"]
    return {"gossip_mix": mix, "gossip_mix_q8": q8}


def unfused_round(torch, flat, res, w, live):
    """The int8 round (error feedback on) as the port ran it before the
    send took its error feedback and the receive took W whole: the kept
    codec and q8 wrappers plus torch ops, one device operation each."""
    from repro_torch.core.compression import (dequantize_int8_rows,
                                              quantize_int8_rows)
    from repro_torch.kernels import gossip_mix as gm

    carried = flat + res
    diag = torch.diagonal(w)
    off = w - torch.diag(diag)
    q, scale = quantize_int8_rows(carried)
    deq = dequantize_int8_rows(q, scale, carried.shape[1])
    mixed = gm.gossip_mix_q8_rows(diag, off, flat, q, scale)
    new_res = torch.where(live[:, None], carried - deq,
                          torch.zeros((), dtype=flat.dtype,
                                      device=flat.device))
    return mixed, new_res


def int8_round_chain(torch, randn, softmax_rows, rounds: int = 15) -> dict:
    """The int8 round's chain (flat, res, W, live) -> (mixed, new_res) at
    the paper's message, one dead node: the unfused sequence against this
    one (``dpsgd._compress_and_mix``), equal outputs, each as 100 rounds
    captured into one CUDA graph, the two graphs replayed in turns; us per
    round and device operations per round (profiler, one eager round)."""
    from repro_torch.core import dpsgd
    from repro_torch.core.compression import QuantConfig
    from repro_torch.graphs import _side_stream

    n = 21_840
    flat, res = randn(N_NODES, n, scale=0.3), randn(N_NODES, n, scale=1e-3)
    w = softmax_rows(N_NODES, N_NODES)
    live = torch.arange(N_NODES, device=flat.device) != N_NODES - 1
    int8 = QuantConfig(mode="int8")
    chains = (("unfused sequence",
               lambda: unfused_round(torch, flat, res, w, live)),
              ("this one", lambda: dpsgd._compress_and_mix(
                  flat, res, w, live, int8)))
    (m0, r0), (m1, r1) = (fn() for _, fn in chains)
    torch.cuda.synchronize()
    check(torch.equal(m0, m1) and torch.equal(r0, r1),
          "the int8 round differs from the unfused sequence")
    side = _side_stream(flat.device)
    graphs = []
    for _, fn in chains:
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(100):
                fn()
        graph.replay()
        graphs.append(graph)
    torch.cuda.synchronize()
    per_round = ([], [])
    for r in range(rounds):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[i].replay()
            end.record()
            end.synchronize()
            per_round[i].append(start.elapsed_time(end) / 100 * 1e3)
    out = {}
    print(f"int8 round (flat, res, W, live) -> (mixed, new_res), "
          f"({N_NODES}, {n}) fp32, outputs bit-equal; 100 rounds in a CUDA "
          f"graph, {rounds} replays in turns:")
    for (label, fn), times in zip(chains, per_round):
        ops = prof.device_profile(fn, 1)
        launches = sum(c for _, _, c in ops)
        out[label] = {"us": statistics.median(times), "launches": launches}
        print(f"   {label:18s} {statistics.median(times):8.3f} us per round "
              f"(min {min(times):.3f}, max {max(times):.3f}), {launches} "
              f"device operations per round: "
              + ", ".join(f"{c}x {name[:40]}" for name, _, c in ops))
    return out


def print_times(name: str, t: dict) -> None:
    """One kernel's times at the path's shape, in microseconds."""
    def us(v):
        return "none" if v is None else f"{v * 1e3:.2f} us"
    dms = "not measured" if t["device_ms"] is None else us(t["device_ms"])
    print(f"{name:15s} {t['shape']}: {us(t['ms'])}/call (device {dms}; in "
          f"a graph {us(t['graph_ms'])}) | plain {us(t['plain_ms'])} | "
          f"library {us(t['library_ms'])} (in a graph "
          f"{us(t['library_graph_ms'])}) | bound {t['bound_ms'] * 1e3:.3f} "
          f"us ({t['bound_by']})")


def against_library(name: str, t: dict, library: str) -> None:
    """Print (host times vary between calls, so nothing fails on them)
    whether a kernel is at or under its one-call library equivalent in a
    graph, and at most 1.5x it as an eager call, both in this run."""
    in_graph = t["graph_ms"] / t["library_graph_ms"]
    eager = t["ms"] / t["library_ms"]
    print(f"{name:15s} against {library}: in a graph {in_graph:.3f}x "
          f"({'at or under' if in_graph <= 1 else 'ABOVE'}), eager "
          f"{eager:.3f}x ({'within' if eager <= 1.5 else 'OVER'} 1.5x)")


def launch_path(torch, w, bufs, calls: int = 10_000) -> None:
    """Where an eager call of the rows mix spends its host time: each piece
    of the call timed alone over ``calls`` calls (time.perf_counter_ns),
    as the wrapper and launch helper did it before the lean launch path
    ("before", rebuilt here for the comparison) and as they do it now
    ("after"). The
    ctypes call launches the kernel each time."""
    from repro_torch.kernels import _backend, _build
    from repro_torch.kernels import gossip_mix as gm

    dev = bufs.device
    m, n = w.shape[0], bufs.shape[1]
    out = torch.empty((m, n), device=dev)
    fn = _build._ENTRIES[("gossip_mix", "gossip_mix_rows_f32")]
    ptrs = (w.data_ptr(), bufs.data_ptr(), out.data_ptr(), m, w.shape[1], n)
    lock = _build._LOCK

    def old_probe():
        return tuple(torch.cuda.get_device_capability(torch.device(dev))) \
            >= (9, 0)

    def old_checks():
        w32 = w.to(torch.float32).contiguous()
        _backend.require_operands(dev, w=w32, bufs=bufs)

    def new_checks():
        _backend.refuse_grad("gossip_mix_rows", w=w, bufs=bufs)
        _backend.require_operands(dev, w=w, bufs=bufs)

    def old_lookup():
        with lock:
            lib = _build._LOADED["gossip_mix"]
        return getattr(lib, "gossip_mix_rows_f32")

    def old_device():
        with torch.cuda.device(dev):
            pass

    def old_call():
        if w.dim() != 2 or bufs.dim() != 2 or w.shape[1] != bufs.shape[0]:
            raise ValueError
        old_probe()
        old_checks()
        o = torch.empty((m, n), dtype=bufs.dtype, device=dev)
        f = old_lookup()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            f(*ptrs[:2], o.data_ptr(), *ptrs[3:], stream)
        return o

    index = dev.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    pieces = (
        ("probe", old_probe, lambda: _backend.use_kernel(dev)),
        ("checks", old_checks, new_checks),
        ("output allocation",
         lambda: torch.empty((m, n), dtype=bufs.dtype, device=dev),
         lambda: torch.empty_like(bufs)),
        ("library lookup (lock, getattr)", old_lookup,
         lambda: _build._ENTRIES.get(("gossip_mix", "gossip_mix_rows_f32"))),
        ("device context", old_device,
         lambda: torch._C._cuda_getDevice() == index),
        ("stream query", lambda: torch.cuda.current_stream(dev).cuda_stream,
         lambda: torch._C._cuda_getCurrentRawStream(index)),
        ("ctypes call (the launch)", lambda: fn(*ptrs, stream),
         lambda: fn(*ptrs, stream)),
        ("whole call", old_call, lambda: gm.gossip_mix_rows(w, bufs)))

    def per_call_us(f):
        for _ in range(100):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            f()
        t = (time.perf_counter_ns() - t0) / calls / 1e3
        torch.cuda.synchronize()
        return t
    print(f"launch path of one gossip_mix_rows call, host us per call over "
          f"{calls} calls (before: the earlier path; after: this one):")
    for label, before, after in pieces:
        b, a = per_call_us(before), per_call_us(after)
        print(f"   {label:32s} before {b:8.3f}  after {a:8.3f}")


def eager_train(torch, params, data, w, steps: int, eta: float = 0.05,
                seed: int = 0):
    """``wireless_dpsgd.train`` with the eager body: the same numpy batch
    draws, each step ``dpsgd.dpsgd_step`` called directly (no graph).
    Returns (params, losses (steps, n), seconds up to the last result)."""
    from repro_torch.core import dpsgd
    from repro_torch.examples import wireless_dpsgd as ex
    from repro_torch.models import cnn

    n = data.x.shape[0]
    w_t = torch.as_tensor(w, dtype=torch.float32, device=data.x.device)
    cfg = dpsgd.DPSGDConfig(eta=eta)
    rng = np.random.default_rng(seed)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        idx = rng.integers(0, data.per_node, size=(n, ex.BATCH))
        params, loss = dpsgd.dpsgd_step(cnn.cnn_loss, params,
                                        ex._batch(data, idx), w_t, cfg)
        losses.append(loss)
    out = torch.stack(losses)
    torch.cuda.synchronize()
    return params, out, time.perf_counter() - t0


def graphed_step_split(torch, step, params, data, w_t,
                       calls: int = 200) -> None:
    """Host time of each piece of a graphed D-PSGD step as train() runs
    it, each timed alone (the card idle before each call, so no piece
    waits on it) over ``calls`` calls: the batch draw and gather, the
    signature (flatten the arguments, key the captured graph), the copy-in
    to the static inputs, the replay, and the outputs' clone."""
    from repro_torch import graphs
    from repro_torch.examples import wireless_dpsgd as ex

    rng = np.random.default_rng(0)

    def draw():
        return ex._batch(data, rng.integers(0, data.per_node,
                                            size=(N_NODES, ex.BATCH)))
    batch = draw()
    leaves, structure = graphs._flatten_args((params, batch, w_t))
    entry = step._entry(w_t.device, leaves, structure)

    def signature():
        lv, st = graphs._flatten_args((params, batch, w_t))
        step._entry(w_t.device, lv, st)

    def host_us(fn):
        total = 0
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            fn()
            total += time.perf_counter_ns() - t0
        torch.cuda.synchronize()
        return total / calls / 1e3
    pieces = [("batch draw and gather", draw), ("signature", signature),
              ("copy-in", lambda: entry.load(leaves)),
              ("replay", entry.graph.replay), ("output clone", entry.fresh),
              ("whole step (the four above)",
               lambda: step(params, batch, w_t))]
    print(f"host us per graphed step, each piece alone over {calls} calls: "
          + ", ".join(f"{label} {host_us(fn):.2f}" for label, fn in pieces))


def phase_slice(torch) -> dict:
    phase("4. slice: the paper run on the card, eager and as a CUDA graph")
    from repro_torch.core import dpsgd, rate_opt
    from repro_torch.examples import wireless_dpsgd as ex
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.models import cnn

    cap = ex.place(N_NODES, EPS)
    t0 = time.perf_counter()
    data = ex.load_data(N_NODES, N_TRAIN, N_TEST, device="cuda")
    print(f"data: {N_TRAIN} train / {N_TEST} test images "
          f"({data.per_node} per node) in {time.perf_counter() - t0:.1f}s")
    # warm-up (cuDNN plans, vmap, a first capture) outside the counted runs
    w_warm = rate_opt.solve(cap, cnn.MODEL_BITS, 0.8).w
    ex.train(ex.init_params(N_NODES, device="cuda"), data, w_warm, 3)
    eager_train(torch, ex.init_params(N_NODES, device="cuda"), data, w_warm,
                3)

    # the same STEPS steps per λ target twice, in turns: the eager body,
    # then the entry point (run_target -> train), whose step is a graph;
    # the pair TIMING_REPEATS times (a shared host stalls a run now and
    # then), every run printed, the medians compared
    results, times, launches = [], [], {"gossip_mix": 0, "gossip_mix_q8": 0}
    for lam_t in ex.LAMBDA_TARGETS:
        w = rate_opt.solve(cap, cnn.MODEL_BITS, lam_t).w
        runs = []
        for rep in range(TIMING_REPEATS):
            e_run = eager_train(torch, ex.init_params(N_NODES, device="cuda"),
                                data, w, STEPS)
            gm.gossip_mix_rows.launches = gm.gossip_mix_q8_rows.launches = 0
            g_run = ex.run_target(cap, lam_t, data, STEPS, verbose=rep == 0)
            torch.cuda.synchronize()
            got = {"gossip_mix": gm.gossip_mix_rows.launches,
                   "gossip_mix_q8": gm.gossip_mix_q8_rows.launches}
            check(got["gossip_mix"] == STEPS, f"gossip_mix launched "
                  f"{got['gossip_mix']} times, want {STEPS}")
            if rep == 0:
                print(f"λ target {lam_t}: launches {got} (gossip_mix "
                      f"expected {STEPS}, one per step)")
                for k in launches:
                    launches[k] += got[k]
            runs.append((e_run, g_run))
        results.append(runs[0][1])
        times.append(([e[2] for e, _ in runs],
                      [g["t_compute_s"] for _, g in runs]))
        print(f"λ target {lam_t}: free-running max|loss diff| (not held): "
              f"graphed vs eager "
              f"{err(runs[0][1]['losses'], runs[0][0][1]):.3e}, two eager "
              f"runs {err(runs[1][0][1], runs[0][0][1]):.3e}, two graphed "
              f"runs {err(runs[1][1]['losses'], runs[0][1]['losses']):.3e}")

    for r, (e_s, g_s) in zip(results, times):
        losses = r["losses"]
        check(losses.shape == (STEPS, N_NODES), f"losses {losses.shape}")
        check(bool(torch.isfinite(losses).all()), "non-finite loss")
        check(0.0 <= r["accuracy"] <= 1.0, f"accuracy {r['accuracy']}")
        first, last = float(losses[:5].mean()), float(losses[-5:].mean())
        check(last < first, f"λ={r['lambda_target']}: loss did not fall "
              f"({first:.4f} -> {last:.4f})")
        g_rate = STEPS / statistics.median(g_s)
        e_rate = STEPS / statistics.median(e_s)
        print(f"λ target {r['lambda_target']}: λ={r['sol'].lam:.4f}, "
              f"t_com={r['t_com_s']:.3f}s for {STEPS} steps, "
              f"accuracy {r['accuracy']:.4f}, loss {first:.4f} -> "
              f"{last:.4f}; compute of {TIMING_REPEATS} runs in turns, "
              f"graphed {', '.join(f'{t:.4f}' for t in g_s)} s, eager "
              f"{', '.join(f'{t:.4f}' for t in e_s)} s; medians "
              f"{g_rate:.2f} vs {e_rate:.2f} steps/s: {g_rate / e_rate:.2f}x "
              f"({'at least' if g_rate >= 4 * e_rate else 'UNDER'} 4x)")

    # graphed against eager on the card, in lockstep: each step starts
    # both from the graphed run's state, on the same batch
    cfg = dpsgd.DPSGDConfig(eta=0.05)
    step = dpsgd.make_dpsgd_step(cnn.cnn_loss, cfg)
    g_loss = g_param = 0.0
    for r in results:
        w_t = torch.as_tensor(r["sol"].w, dtype=torch.float32, device="cuda")
        params = ex.init_params(N_NODES, device="cuda")
        rng = np.random.default_rng(0)
        for _ in range(STEPS):
            b = ex._batch(data, rng.integers(0, data.per_node,
                                             size=(N_NODES, ex.BATCH)))
            p_e, l_e = dpsgd.dpsgd_step(cnn.cnn_loss, params, b, w_t, cfg)
            params, l_g = step(params, b, w_t)
            g_loss = max(g_loss, err(l_g, l_e))
            g_param = max(g_param, max(err(a, c) for a, c in zip(
                dpsgd._leaves(params), dpsgd._leaves(p_e))))
    print(f"graphed vs eager on the card, {STEPS} steps per λ target in "
          f"lockstep: max|loss diff| {g_loss:.3e}, max|param diff| "
          f"{g_param:.3e}")
    check(g_loss <= 1e-4, f"graphed and eager losses differ by {g_loss}")
    check(g_param <= TOL_FP32,
          f"graphed and eager parameters differ by {g_param}")

    # The first steps again on the CPU (plain versions), in lockstep: each
    # step starts card and CPU from the card's state and batch. Run free,
    # the two drift apart at the first near-tie of a max-pool or ReLU whose
    # gradient flips sides (the loss is continuous, its gradient is not),
    # so the free-running gap is printed but not held.
    cpu = ex.NodeData(data.x.cpu(), data.y.cpu(), data.test_x[:1].cpu(),
                      data.test_y[:1].cpu())
    to_cpu = lambda t: dpsgd._tree_map(lambda x: x.cpu(), t)  # noqa: E731
    lock_loss = lock_param = free = 0.0
    for r in results:
        w = r["sol"].w
        params = ex.init_params(N_NODES, device="cuda")
        rng = np.random.default_rng(0)              # train()'s batch stream
        for _ in range(CPU_STEPS):
            idx = rng.integers(0, data.per_node, size=(N_NODES, ex.BATCH))
            p_c, l_c = step(to_cpu(params), ex._batch(cpu, idx), w)
            params, l_g = step(params, ex._batch(data, idx), w)
            lock_loss = max(lock_loss, err(l_g.cpu(), l_c))
            lock_param = max(lock_param, max(
                err(a.cpu(), b) for a, b in zip(dpsgd._leaves(params),
                                                dpsgd._leaves(p_c))))
        _, cpu_losses, _ = ex.train(ex.init_params(N_NODES, device="cpu"),
                                    cpu, w, CPU_STEPS)
        free = max(free, err(cpu_losses, r["losses"][:CPU_STEPS].cpu()))
    print(f"card vs CPU, first {CPU_STEPS} steps in lockstep: max|loss diff| "
          f"{lock_loss:.3e}, max|param diff| {lock_param:.3e}; free-running "
          f"max|loss diff| {free:.3e} (not held)")
    check(lock_loss <= 1e-4, f"card and CPU losses differ by {lock_loss}")
    check(lock_param <= TOL_FP32,
          f"card and CPU mixed parameters differ by {lock_param}")

    # where a graphed step's time goes: the profiler's device busy time
    # over PROFILE_STEPS steps as train() runs them (batch gather, copy-in,
    # replay, the outputs' clone), and the card's time per step from CUDA
    # events around PROFILE_STEPS steps on batches gathered first (the host
    # stays ahead of the card), each against the run's wall time per step
    wall = {"graphed": 1e3 * statistics.median(times[0][1]) / STEPS,
            "eager": 1e3 * statistics.median(times[0][0]) / STEPS}
    w_t = torch.as_tensor(results[0]["sol"].w, dtype=torch.float32,
                          device="cuda")
    params = ex.init_params(N_NODES, device="cuda")
    batches = [ex._batch(data, np.random.default_rng(i).integers(
        0, data.per_node, size=(N_NODES, ex.BATCH)))
        for i in range(PROFILE_STEPS)]
    step.prepare(params, batches[0], w_t)

    def graphed_steps():
        p, rng = params, np.random.default_rng(0)
        for _ in range(PROFILE_STEPS):
            p, _ = step(p, ex._batch(data, rng.integers(
                0, data.per_node, size=(N_NODES, ex.BATCH))), w_t)

    def graphed_on_batches():
        p = params
        for b in batches:
            p, _ = step(p, b, w_t)

    def eager_steps():
        p = params
        for b in batches:
            p, _ = dpsgd.dpsgd_step(cnn.cnn_loss, p, b, w_t, cfg)
    dev_ms = time_ms(torch, graphed_on_batches, reps=1, rounds=5,
                     warmup=2) / PROFILE_STEPS
    # the same step object past its first replays: STEADY_STEPS steps as
    # train() runs them (each run_target captures a fresh step, and its
    # 40 steps include the first replays of that capture)
    p, rng = params, np.random.default_rng(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEADY_STEPS):
        p, _ = step(p, ex._batch(data, rng.integers(
            0, data.per_node, size=(N_NODES, ex.BATCH))), w_t)
    torch.cuda.synchronize()
    steady = 1e3 * (time.perf_counter() - t0) / STEADY_STEPS
    print(f"graphed step: {dev_ms:.4f} ms of card time per step (CUDA "
          f"events over {PROFILE_STEPS} steps on batches gathered first) "
          f"vs {wall['graphed']:.4f} ms wall in the entry point's run (idle "
          f"share {1 - dev_ms / wall['graphed']:.3f}) and {steady:.4f} ms "
          f"wall over {STEADY_STEPS} steps of one prepared step, "
          f"{1e3 / steady:.2f} steps/s (idle share "
          f"{1 - dev_ms / steady:.3f})")
    graphed_step_split(torch, step, params, data, w_t)
    busy = {}
    for label, run in (("graphed", graphed_steps), ("eager", eager_steps)):
        rows = prof.device_profile(run, PROFILE_STEPS)
        if not rows:
            print(f"profile ({label}): no device time in the trace "
                  "(not measured)")
            continue
        busy[label] = sum(r[1] for r in rows)
        print(f"profile of {PROFILE_STEPS} {label} steps: device busy "
              f"{busy[label]:.4f} ms/step in {sum(r[2] for r in rows)} "
              f"launches vs {wall[label]:.4f} ms/step wall, idle share "
              f"{1 - busy[label] / wall[label]:.3f}; top kernels (ms/step):")
        for name, ms, calls in rows[:8]:
            print(f"   {ms:.4f} ms  {calls:3d}x  {name[:90]}")
    return {"cap": cap, "data": data, "results": results,
            "launches": launches}


def phase_compressed(torch, sl: dict) -> int:
    phase("5. compressed path: int8 error feedback, one dead node")
    from repro_torch.core import dpsgd, topology
    from repro_torch.core.compression import QuantConfig, quantize_int8_rows
    from repro_torch.examples import wireless_dpsgd as ex
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import quantize as qz
    from repro_torch.models import cnn

    data, sol = sl["data"], sl["results"][0]["sol"]     # the λ = 0.1 run
    ids = list(range(N_NODES - 1))                      # the last node is dead
    adj = topology.adjacency_from_rates(sl["cap"], sol.rates_bps)
    w = dpsgd.embed_w(topology.paper_w(adj[np.ix_(ids, ids)]), ids, N_NODES)
    live = torch.tensor([i in ids for i in range(N_NODES)], device="cuda")
    step = dpsgd.make_dpsgd_compressed_step(
        cnn.cnn_loss, QuantConfig(mode="int8"), dpsgd.DPSGDConfig(eta=0.05))
    params = ex.init_params(N_NODES, device="cuda")
    res = dpsgd.zero_residuals(params)
    rng = np.random.default_rng(1)

    def batch():
        return ex._batch(data, rng.integers(0, data.per_node,
                                            size=(N_NODES, ex.BATCH)))

    counters = {"quantize_int8_ef": qz.quantize_int8_ef,
                "quantize_int8": qz.quantize_int8,
                "dequantize_int8": qz.dequantize_int8,
                "gossip_mix_q8": gm.gossip_mix_q8_rows,
                "gossip_mix": gm.gossip_mix_rows}
    for fn in counters.values():
        fn.launches = 0
    for r in range(COMPRESSED_ROUNDS):
        params, res, losses = step(params, batch(), w, live, res)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in counters.items()}
    want = {"quantize_int8_ef": COMPRESSED_ROUNDS, "quantize_int8": 0,
            "dequantize_int8": 0, "gossip_mix_q8": COMPRESSED_ROUNDS,
            "gossip_mix": 0}
    print(f"{COMPRESSED_ROUNDS} rounds: launches {counts} (expected {want}), "
          f"losses {[round(float(v), 4) for v in losses]}")
    check(counts == want, f"launches {counts}, want {want}")
    launches = counts["gossip_mix_q8"]
    leaves = dpsgd._leaves(params) + dpsgd._leaves(res) + [losses]
    check(all(bool(torch.isfinite(t).all()) for t in leaves),
          "non-finite parameters, residuals or losses")

    # one more step from this state, on the card and on the CPU
    b = batch()
    to_cpu = lambda t: dpsgd._tree_map(lambda x: x.cpu(), t)  # noqa: E731
    p_g, r_g, _ = step(params, b, w, live, res)
    p_c, r_c, _ = step(to_cpu(params), to_cpu(b), w, live.cpu(), to_cpu(res))

    def carried(p, e):
        return (torch.cat([x.reshape(N_NODES, -1) for x in dpsgd._leaves(p)], 1)
                + torch.cat([x.reshape(N_NODES, -1) for x in dpsgd._leaves(e)],
                            1))
    q_g, s_g = quantize_int8_rows(carried(params, res))
    q_c, s_c = quantize_int8_rows(carried(to_cpu(params), to_cpu(res)))
    check(torch.equal(q_g.cpu(), q_c), "int8 payload differs card vs CPU")
    check(torch.equal(s_g.cpu(), s_c), "int8 scales differ card vs CPU")
    e_p = max(err(a.cpu(), c) for a, c in zip(dpsgd._leaves(p_g),
                                              dpsgd._leaves(p_c)))
    e_r = max(err(a.cpu(), c) for a, c in zip(dpsgd._leaves(r_g),
                                              dpsgd._leaves(r_c)))
    dead = all(torch.equal(a[-1], b_[-1]) for a, b_ in
               zip(dpsgd._leaves(p_g), dpsgd._leaves(params)))
    print(f"card vs CPU, one step: q bit-equal, params max|diff| {e_p:.3e}, "
          f"residuals {e_r:.3e}, dead node carried verbatim: {dead}")
    check(e_p <= 1e-5 and e_r <= 1e-5, "compressed step differs card vs CPU")
    check(dead, "the dead node's parameters changed")
    return launches


def phase_attention_kernels(torch) -> dict:
    phase("3b. flash_attention and rglru_scan against their plain versions")
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"flash_attention": 0.0, "rglru_scan": 0.0}
    tol = {torch.float32: TOL_FLASH_FP32, torch.bfloat16: TOL_BF16}

    def hold(name, got, want, tol, what):
        e = err(got, want)
        print(f"{name:15s} {what:58s} max|err| {e:.3e} (tol {tol:g})")
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} {what}: {got.shape}/{got.dtype} vs "
              f"{want.shape}/{want.dtype}")
        check(e <= tol, f"{name} {what}: max|err| {e} > {tol}")
        errs[name] = max(errs[name], e)

    def qkv(b, s, hq, hkv, d, dtype):
        return tuple(torch.randn((b, s, h, d), generator=gen, device=dev
                                 ).to(dtype) for h in (hq, hkv, hkv))

    # the slice's prefill shape, then edge shapes: ragged S, D in
    # {16, 64, 80, 128}, window 0 causal and not, Hq == Hkv, bands that skip;
    # the bf16 (wgmma) kernel also at its tile edges (128 query rows, 64
    # keys a block): S = T of 1, 63, 129, 200 and 4097, windows 1, 33, 64,
    # 100 and 2048, D of 16 to 256, GQA groups 1, 2 and 10, causal off
    main = (SERVE_BATCH, SERVE_PROMPT, 10, 1, 256, True, 2048)
    bf16 = torch.bfloat16
    cases = [(*main, bf16), (*main, torch.float32),
             (2, 33, 4, 2, 64, True, 0, torch.float32),
             (2, 80, 4, 1, 16, True, 32, torch.float32),
             (2, 130, 8, 2, 64, True, 48, bf16),
             (1, 257, 4, 4, 128, True, 0, torch.float32),
             (1, 65, 4, 4, 80, True, 0, torch.float32),
             (2, 100, 4, 2, 64, False, 0, torch.float32),
             (2, 100, 4, 2, 16, False, 0, bf16),
             (2, 1, 4, 2, 64, True, 0, bf16),
             (2, 63, 4, 4, 80, True, 33, bf16),
             (1, 129, 10, 1, 128, True, 1, bf16),
             (2, 200, 4, 2, 16, True, 64, bf16),
             (1, 200, 10, 1, 256, False, 100, bf16),
             (2, 129, 4, 2, 64, False, 0, bf16),
             (1, 63, 2, 1, 256, True, 2048, bf16),
             (1, 4097, 10, 1, 256, True, 2048, bf16),
             (1, 4097, 2, 2, 128, True, 0, bf16)]
    for b, s, hq, hkv, d, causal, window, dtype in cases:
        q, k, v = qkv(b, s, hq, hkv, d, dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        what = (f"({b},{s},{hq}/{hkv},{d}) causal={causal} w={window} "
                f"{str(dtype)[6:]}")
        hold("flash_attention", got, want, tol[dtype], what)
        if dtype != bf16:
            continue
        e = row_err(got, want)
        print(f"{'':15s} {what:58s} row |err|/|want| {e:.3e} "
              f"(tol {TOL_FLASH_ROW:g})")
        check(e <= TOL_FLASH_ROW,
              f"flash_attention {what}: row error {e} > {TOL_FLASH_ROW}")
        if causal and 1 < window <= (s - 1) // 128 * 128:
            # the bar's power: planted wrong kernels that lose the window's
            # edge tile (a query tile past the first one has its band
            # clipped), or one key of each full window
            for wrong, bad in (
                    ("edge tile dropped",
                     flash_edge_tile_dropped(torch, q, k, v, window)),
                    ("window one key short", fa.flash_attention_plain(
                        q, k, v, causal=True, window=window - 1))):
                e_bad = row_err(bad, want)
                print(f"{'':15s} {'planted wrong kernel: ' + wrong:58s} "
                      f"row |err|/|want| {e_bad:.3e}, max|err| "
                      f"{err(bad, want):.3e}")
                check(e_bad > TOL_FLASH_ROW,
                      f"the row bar passes a wrong kernel ({wrong}) at "
                      f"{what}")
    for d, dtype in ((320, torch.float32), (20, bf16)):
        before = fa.flash_attention.launches
        try:
            fa.flash_attention(*qkv(1, 8, 2, 1, d, dtype))
        except ValueError as e:
            check("head_dim" in str(e), f"head_dim {d}: wrong message {e}")
            check(fa.flash_attention.launches == before,
                  "launched before raising")
            print(f"flash_attention ValueError on head_dim {d} "
                  f"{str(dtype)[6:]}: ok ({e})")
        else:
            fail(f"flash_attention accepted head_dim {d} in {dtype}")

    # the shapes of the MLA and encoder-decoder prefills, through the
    # entry the models call (ops: v narrower than q and k is zero-padded
    # to q's D there, the output cut back): deepseek-v2-lite-16b's MLA (D
    # 192, v 128, 16 heads, causal; the bf16 kernel's DP = 256 instance,
    # whose 4th 64-lane TMA box lies wholly past D), seamless's encoder
    # and cross attention (16 heads of 64, non-causal, T = S = 2048) and
    # decoder (causal), and cross attention with T != S both ways
    for dtype in (bf16, torch.float32):
        for b, s, t, h, d, dv, causal in NEW_FLASH_CASES:
            q, k = (torch.randn((b, n, h, d), generator=gen, device=dev
                                ).to(dtype) for n in (s, t))
            v = torch.randn((b, t, h, dv), generator=gen, device=dev
                            ).to(dtype)
            got = ops.flash_attention_gqa(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(
                q, k, F.pad(v, (0, d - dv)), causal=causal)[..., :dv]
            what = (f"({b},{s}x{t},{h},{d}/{dv}) causal={causal} "
                    f"{str(dtype)[6:]}")
            hold("flash_attention", got, want.contiguous(), tol[dtype], what)
            if dtype == bf16:
                e = row_err(got, want)
                print(f"{'':15s} {what:58s} row |err|/|want| {e:.3e} "
                      f"(tol {TOL_FLASH_ROW:g})")
                check(e <= TOL_FLASH_ROW, f"flash_attention {what}: row "
                      f"error {e} > {TOL_FLASH_ROW}")
            del q, k, v, got, want

    # the served prefill and decode shapes, then S across the chained
    # scan's 32-step chunks (33, 65: one and two chunks past a boundary)
    for b, s, d, with_h0 in ((SERVE_BATCH, SERVE_PROMPT, 2560, True),
                             (SERVE_BATCH, 1, 2560, True),
                             (3, 37, 100, False), (2, 70, 100, True),
                             (2, 33, 2560, True), (SERVE_BATCH, 65, 2560, True),
                             (3, 65, 300, False)):
        a = torch.sigmoid(torch.randn((b, s, d), generator=gen, device=dev))
        x = torch.randn((b, s, d), generator=gen, device=dev)
        h0 = torch.randn((b, d), generator=gen, device=dev) if with_h0 \
            else None
        got = rg.rglru_scan(a, x, h0)
        torch.cuda.synchronize()
        hold("rglru_scan", got, rg.rglru_scan_plain(a, x, h0), TOL_RGLRU,
             f"({b},{s},{d}) h0={with_h0}")

    # times at the slice's shapes: flash in bf16 (the served dtype) and
    # fp32; rglru at the prefill (S = 4096) and decode (S = 1) shapes
    out = {}
    b, s, hq, hkv, d, causal, window = main
    qpos = torch.arange(s, device=dev)[:, None]
    kpos = torch.arange(s, device=dev)[None, :]
    band = (kpos <= qpos) & (qpos - kpos < window)
    for dtype, elt, peak, kname in (
            (torch.bfloat16, 2, cost.BF16_FLOPS,
             "flash_attention_bf16_kernel"),
            (torch.float32, 4, cost.FP32_FLOPS, "flash_attention_kernel")):
        q, k, v = qkv(b, s, hq, hkv, d, dtype)

        def kernel():
            return fa.flash_attention(q, k, v, causal=causal, window=window)

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=band, enable_gqa=True)
        lib_err = err(library().transpose(1, 2), kernel())
        nbytes, flops = cost.flash_cost(b, s, hq, hkv, d, window, elt)
        b_ms, b_by = cost.bound(nbytes, flops, peak)
        out[str(dtype)[6:]] = {
            "ms": time_ms(torch, kernel, reps=10, rounds=3, warmup=2),
            "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=causal, window=window), reps=2, rounds=3,
                warmup=1),
            "library_ms": time_ms(torch, library, reps=10, rounds=3,
                                  warmup=2),
            "device_ms": prof.device_ms(kernel, kname, calls=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"q ({b},{s},{hq},{d}) k/v ({b},{s},{hkv},{d}) "
                     f"{str(dtype)[6:]}, causal, window {window}"}
        t = out[str(dtype)[6:]]
        dev_t = t["device_ms"] if t["device_ms"] is not None else t["ms"]
        print(f"flash_attention {t['shape']}: library "
              f"(scaled_dot_product_attention, band mask) vs kernel "
              f"max|diff| {lib_err:.3e}; {flops:.4e} flops over the band: "
              f"{flops / dev_t / 1e9:.1f} TFLOP/s "
              f"({'device' if t['device_ms'] is not None else 'per call'}), "
              f"{b_ms / dev_t * 100:.1f} % of the bound; library "
              f"{t['library_ms']:.4f} ms in this run")
    flash = dict(out["bfloat16"], fp32=out["float32"])
    # the new prefill shapes in bf16 (the served dtype) beside SDPA on the
    # same inputs and their bound; the work counts 2 D + 2 Dv flops a
    # (query, key) pair (MLA: 2 x 192 + 2 x 128; the kernel, on v padded
    # to 192 and both products over its DP = 256 tile, does 2 x 256 +
    # 2 x 256, which caps it at 62.5 % of this bound)
    for key, (b, s, t, h, d, dv, causal) in NEW_FLASH_TIMED.items():
        q, k = (torch.randn((b, n, h, d), generator=gen, device=dev
                            ).to(bf16) for n in (s, t))
        v = torch.randn((b, t, h, dv), generator=gen, device=dev).to(bf16)

        def kernel():
            return ops.flash_attention_gqa(q, k, v, causal=causal)

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal)
        lib_err = err(library().transpose(1, 2), kernel())
        nbytes, flops = cost.attn_cost(b, s, t, h, d, dv, causal, 2)
        b_ms, b_by = cost.bound(nbytes, flops, cost.BF16_FLOPS)
        t_ = {"ms": time_ms(torch, kernel, reps=10, rounds=3, warmup=2),
              "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                  q, k, F.pad(v, (0, d - dv)), causal=causal), reps=2,
                  rounds=3, warmup=1),
              "library_ms": time_ms(torch, library, reps=10, rounds=3,
                                    warmup=2),
              # every device operation of the call: v's padding counts
              "device_ms": prof.device_ms(kernel, "", calls=3),
              "bound_ms": b_ms, "bound_by": b_by,
              "shape": f"q ({b},{s},{h},{d}) k ({b},{t},{h},{d}) v "
                       f"({b},{t},{h},{dv}) bf16, "
                       f"{'causal' if causal else 'non-causal'}"}
        flash[key] = t_
        dev_t = t_["device_ms"] if t_["device_ms"] is not None else t_["ms"]
        print(f"flash_attention [{key}] {t_['shape']}: library "
              f"(scaled_dot_product_attention) vs kernel max|diff| "
              f"{lib_err:.3e}; {flops:.4e} flops of work: "
              f"{flops / dev_t / 1e9:.1f} TFLOP/s, {b_ms / dev_t * 100:.1f} "
              f"% of the bound")
        del q, k, v
    for b, s, d, reps in ((SERVE_BATCH, SERVE_PROMPT, 2560, 1),
                          (SERVE_BATCH, 1, 2560, 100)):
        a = torch.sigmoid(torch.randn((b, s, d), generator=gen, device=dev))
        x = torch.randn((b, s, d), generator=gen, device=dev)
        h0 = torch.randn((b, d), generator=gen, device=dev)
        b_ms, b_by = cost.bound(*cost.rglru_cost(b, s, d))
        out[s] = {
            "ms": time_ms(torch, lambda: rg.rglru_scan(a, x, h0), reps=20),
            # the plain version is a Python loop over time: at S = 4096,
            # 3 rounds of 1 call after 1 warm-up call
            "plain_ms": time_ms(torch, lambda: rg.rglru_scan_plain(a, x, h0),
                                reps=reps, rounds=3, warmup=1),
            "library_ms": None,
            # the chained scan's memset of its flags counts too
            "device_ms": prof.device_ms(lambda: rg.rglru_scan(a, x, h0),
                                   ("rglru_scan_kernel", "Memset"),
                                   calls=10),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"a, b ({b},{s},{d}) fp32, h0 ({b},{d})"}
    rglru = dict(out[SERVE_PROMPT], decode=out[1])
    for name, t in (("flash_attention", flash),
                    ("flash_attention", flash["fp32"]),
                    *(("flash_attention", flash[k]) for k in NEW_FLASH_TIMED),
                    ("rglru_scan", rglru), ("rglru_scan", rglru["decode"])):
        dms = "not measured" if t["device_ms"] is None \
            else f"{t['device_ms']:.4f} ms"
        lib = "none" if t["library_ms"] is None \
            else f"{t['library_ms']:.4f} ms"
        dev_t = t["device_ms"] if t["device_ms"] is not None else t["ms"]
        print(f"{name:15s} {t['shape']}: {t['ms']:.4f} ms/call "
              f"(device {dms}) | plain {t['plain_ms']:.4f} ms | library "
              f"{lib} | bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / dev_t * 100:.1f} % of it "
              f"({'device' if t['device_ms'] is not None else 'per call'})")
    flash["max_abs_err"] = errs["flash_attention"]
    rglru["max_abs_err"] = errs["rglru_scan"]
    return {"flash_attention": flash, "rglru_scan": rglru}


def phase_rwkv_kernel(torch) -> dict:
    phase("3c. rwkv6_scan against its plain version")
    from repro_torch.kernels import rwkv6_scan as rw

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0

    def inputs(b, s, h, d, regime="test"):
        """Drawn as tests/test_kernels.py:110-114 draws them, plus s0; or
        with the decays of a regime: "served", log w = -exp(U(0.5, 2) +
        N(0, 1)) as models/rwkv6.py's w0 and LoRA give them (the 1e-12
        floor of w live), or "weak", log w ~ -1e-3 (a ~1000-step memory)
        with k scaled by sqrt(1 - w^2), so that the state keeps the unit
        scale the absolute bar was set for."""
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        r, k, v = (randn(b, s, h, d) for _ in range(3))
        if regime == "served":
            lw = -torch.exp(0.5 + 1.5 * torch.rand(
                (b, s, h, d), generator=gen, device=dev) + randn(b, s, h, d))
        elif regime == "weak":
            lw = -1e-3 * torch.exp(0.1 * randn(b, s, h, d))
            k = k * torch.sqrt(-torch.expm1(2 * lw))
        else:
            lw = -torch.exp(randn(b, s, h, d) * 0.5)
        w = torch.exp(lw)
        u = randn(h, d) * 0.1
        s0 = randn(b, h, d, d)
        return r, k, v, w, u, s0

    # the served shape (B = 4, S = 4096, H = 64, D = 64), in both decay
    # regimes too, then edge shapes: S in {1, 33}, D in {8, 16, 32}, H = 1,
    # and S one short of the kernel's 16-step chunk and one past it
    cfg = (SERVE_BATCH, SERVE_PROMPT, 64, 64)
    cases = [(*cfg, True, "test"), (*cfg, False, "test"),
             (*cfg, True, "served"), (*cfg, True, "weak")] + [
        (2, s, 1, d, d != 16, "test") for s in (1, 33) for d in (8, 16, 32)
    ] + [(2, s, 2, 64, True, "served") for s in (15, 17)]
    for b, s, h, d, with_s0, regime in cases:
        r, k, v, w, u, s0 = inputs(b, s, h, d, regime)
        s0 = s0 if with_s0 else None
        y, st = rw.rwkv6_scan(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        want_y, want_s = rw.rwkv6_scan_plain(r, k, v, w, u, s0, RWKV_CHUNK)
        check(y.shape == want_y.shape and st.shape == want_s.shape
              and y.dtype == st.dtype == torch.float32,
              f"rwkv6_scan ({b},{s},{h},{d}): {y.shape}/{st.shape}")
        e = max(err(y, want_y), err(st, want_s))
        print(f"rwkv6_scan     ({b},{s},{h},{d}) s0={with_s0!s:5s} "
              f"{regime:6s} decays: max|err| y and state {e:.3e} "
              f"(tol {TOL_RWKV:g})")
        check(e <= TOL_RWKV, f"rwkv6_scan ({b},{s},{h},{d}): max|err| {e}")
        worst = max(worst, e)
    # the handoff decode reads: the kernel's final state after S steps and
    # one plain step (models.rwkv6.wkv_step) against the kernel's own
    # output and state after S + 1 steps, at the served heads
    from repro_torch.models.rwkv6 import wkv_step

    r, k, v, w, u, _ = inputs(SERVE_BATCH, SERVE_PROMPT + 1, 64, 64)
    y_all, s_all = rw.rwkv6_scan(r, k, v, w, u)
    _, s_pre = rw.rwkv6_scan(*(x[:, :-1] for x in (r, k, v, w)), u)
    s_next, y_next = wkv_step(s_pre, r[:, -1], k[:, -1], v[:, -1], w[:, -1],
                              u)
    e = max(err(y_next, y_all[:, -1]), err(s_next, s_all))
    print(f"rwkv6_scan     handoff: state after {SERVE_PROMPT} steps + one "
          f"plain step vs the kernel over {SERVE_PROMPT + 1}: max|err| "
          f"{e:.3e} (tol {TOL_RWKV:g})")
    check(e <= TOL_RWKV, f"rwkv6_scan handoff: max|err| {e}")

    r, k, v, w, u, s0 = inputs(1, 4, 2, 16)
    wide = [torch.ones((1, 2, 1, 136), device=dev) for _ in range(4)]
    for what, args, match in (
            ("mismatched shapes", (r, k[:, :3], v, w, u), "one shape"),
            ("a bf16 state", (r, k, v, w, u, s0.to(torch.bfloat16)),
             "float32"),
            ("head size 136", (*wide, torch.ones((1, 136), device=dev)),
             "head size")):
        before = rw.rwkv6_scan.launches
        try:
            rw.rwkv6_scan(*args)
        except ValueError as e:
            check(match in str(e), f"rwkv6_scan {what}: wrong message {e}")
            check(rw.rwkv6_scan.launches == before,
                  f"rwkv6_scan {what}: launched before raising")
            print(f"rwkv6_scan     ValueError on {what}: ok")
        else:
            fail(f"rwkv6_scan accepted {what} on CUDA tensors")

    # time at the served shape, with s0 (prefill passes the cache's zeros)
    r, k, v, w, u, s0 = inputs(*cfg)
    b_ms, b_by = cost.bound(*cost.rwkv_cost(*cfg))
    out = {"ms": time_ms(torch, lambda: rw.rwkv6_scan(r, k, v, w, u, s0),
                         reps=20),
           "plain_ms": time_ms(torch, lambda: rw.rwkv6_scan_plain(
               r, k, v, w, u, s0, RWKV_CHUNK), reps=1, rounds=3, warmup=1),
           "library_ms": None,
           "device_ms": prof.device_ms(lambda: rw.rwkv6_scan(
               r, k, v, w, u, s0), "rwkv6_scan_kernel", calls=10),
           "bound_ms": b_ms, "bound_by": b_by,
           "shape": "r, k, v, w (%d,%d,%d,%d) fp32, s0 (%d,%d,%d,%d)"
                    % (*cfg, cfg[0], cfg[2], cfg[3], cfg[3]),
           "max_abs_err": worst}
    dms = "not measured" if out["device_ms"] is None \
        else f"{out['device_ms']:.4f} ms"
    dev_t = out["device_ms"] if out["device_ms"] is not None else out["ms"]
    print(f"rwkv6_scan     {out['shape']}: {out['ms']:.4f} ms/call (device "
          f"{dms}) | plain (chunk {RWKV_CHUNK}) {out['plain_ms']:.4f} ms | "
          f"library none | bound {b_ms:.4f} ms ({b_by}), "
          f"{b_ms / dev_t * 100:.1f} % of it "
          f"({'device' if out['device_ms'] is not None else 'per call'})")
    return {"rwkv6_scan": out}


def phase_quantize_kernels(torch) -> dict:
    phase("3d. the int8 codec and the int8 round's send against their plain "
          "versions")
    from repro_torch.core import compression as comp
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as qz

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    for fn in (qz.quantize_int8, qz.dequantize_int8):   # this phase's count
        fn.launches = 0

    def same(what, got, want):
        """Check ``got`` bit-equal to ``want``; max|err| of each pair."""
        ok = all(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
                 for a, b in zip(got, want))
        print(f"quantize       {what:62s} bit-equal: {ok}")
        check(ok, f"int8 codec {what}: kernel and plain version differ")
        return [err(a, b) for a, b in zip(got, want)]

    def randn(rows, length, scale=3.0, dtype=torch.float32):
        return (torch.randn((rows, length), generator=gen, device=dev)
                * scale).to(dtype)

    # the TPU kernels' contract through ops (256-lane blocks, ragged C,
    # fp32 and bf16 inputs, fp32 and bf16 outputs)
    for rows, c in ((8, 512), (5, 700), (16, 256), (N_NODES, 21_840)):
        for dtype in (torch.float32, bf16):
            x = randn(rows, c, dtype=dtype)
            q, s = ops.quantize_int8(x)
            qp, sp = qz.quantize_int8_plain(x, 256)
            outs = [ops.dequantize_int8(q, s, dt) for dt in (torch.float32,
                                                            bf16)]
            want = [qz.dequantize_int8_plain(qp, sp, 256, c, dt)
                    for dt in (torch.float32, bf16)]
            torch.cuda.synchronize()
            same(f"ops ({rows}, {c}) {str(dtype)[6:]} in, fp32/bf16 out",
                 [q, s, *outs], [qp[:, :c], sp, *want])
    # the wire format (2048-lane blocks) through core.compression, at the
    # path's message and at ragged lengths
    for rows, length in ((N_NODES, 21_840), (N_NODES, 21_843), (3, 2049),
                         (1, 1)):
        x = randn(rows, length, scale=0.3)
        q, s = comp.quantize_int8_rows(x)
        d = comp.dequantize_int8_rows(q, s, length)
        qp, sp = qz.quantize_int8_plain(x, 2048)
        dp = qz.dequantize_int8_plain(qp, sp, 2048, length)
        torch.cuda.synchronize()
        e = same(f"wire format ({rows}, {length}) fp32", [q, s, d],
                 [qp, sp, dp])
        if (rows, length) == (N_NODES, 21_840):     # the path's message
            errs = {"quantize_int8": max(e[:2]), "dequantize_int8": e[2]}
    # the int8 round's send (error feedback in the same launch) against its
    # plain version and against the unfused sequence of launches (the
    # kept codec wrappers plus torch ops): ragged lengths, one dead node,
    # error feedback on and off
    for rows, length in ((N_NODES, 21_840), (N_NODES, 21_843), (3, 2049),
                         (1, 1)):
        for dead in (False, True):
            for ef in (True, False):
                flat = randn(rows, length, scale=0.3)
                res = randn(rows, length, scale=1e-3)
                live = torch.ones(rows, dtype=torch.bool, device=dev)
                live[-1] = not dead
                got = qz.quantize_int8_ef(flat, res, live, ef)
                carried = flat + res if ef else flat
                q, s = comp.quantize_int8_rows(carried)
                deq = comp.dequantize_int8_rows(q, s, length)
                unfused = (q, s, torch.where(
                    live[:, None], carried - deq if ef else res,
                    torch.zeros((), dtype=flat.dtype, device=dev)))
                torch.cuda.synchronize()
                what = (f"send ({rows}, {length}), "
                        f"{'one dead node' if dead else 'all live'}, "
                        f"feedback {'on' if ef else 'off'}")
                e = same(f"{what}: plain",
                         got, qz.quantize_int8_ef_plain(flat, res, live, ef))
                same(f"{what}: unfused sequence", got, unfused)
                if (rows, length, dead, ef) == (N_NODES, 21_840, True, True):
                    errs["quantize_int8_ef"] = max(e)

    # the ValueError contracts, raised before any launch
    qz8 = torch.zeros((2, 512), dtype=torch.int8, device=dev)
    for what, call, match in (
            ("a 3-lane scale block", lambda: qz.quantize_int8(
                randn(2, 9), 3), "scale block"),
            ("a 1-D input", lambda: qz.quantize_int8(randn(1, 9)[0]), "2-D"),
            ("an fp16 input", lambda: qz.quantize_int8(
                randn(2, 9, dtype=torch.float16)), "float32 or bfloat16"),
            ("3 scales for 2 blocks", lambda: qz.dequantize_int8(
                qz8, torch.ones((2, 3), device=dev)), "one per block"),
            ("a length past the payload", lambda: qz.dequantize_int8(
                qz8, torch.ones((2, 2), device=dev), length=600), "fit"),
            ("a send of ragged res", lambda: qz.quantize_int8_ef(
                randn(2, 9), randn(2, 8), torch.ones(2, dtype=torch.bool,
                                                     device=dev)), "one"),
            ("a send of a float mask", lambda: qz.quantize_int8_ef(
                randn(2, 9), randn(2, 9), torch.ones(2, device=dev)),
             "bool")):
        counted = (qz.quantize_int8, qz.dequantize_int8, qz.quantize_int8_ef)
        before = [fn.launches for fn in counted]
        try:
            call()
        except ValueError as e:
            check(match in str(e), f"int8 codec {what}: wrong message {e}")
            check([fn.launches for fn in counted] == before,
                  f"int8 codec {what}: launched before raising")
            print(f"quantize       ValueError on {what}: ok")
        else:
            fail(f"int8 codec accepted {what} on CUDA tensors")

    # times: at the path's message, (6, 21 840) fp32 in 2048-lane blocks,
    # and at (64, 1 048 576) fp32, large enough to read the HBM rate (both
    # formats; printed only). Dequantize's library call is one broadcast
    # multiply of the int8 payload by its scales, trimmed by a view (timed
    # here only; quantize has no single-call equivalent)
    out = {}
    for rows, length, block, reps in ((N_NODES, 21_840, 2048, 100),
                                      (64, 1 << 20, 2048, 10),
                                      (64, 1 << 20, 256, 10)):
        x = randn(rows, length, scale=0.3)
        q, s = qz.quantize_int8(x, block)

        def library():
            return (q.view(rows, -1, block) * s[..., None]).view(
                rows, -1)[:, :length]
        lib_err = err(library(), qz.dequantize_int8(q, s, block, length))
        print(f"dequantize_int8 ({rows}, {length}), {block}-lane blocks: "
              f"library (int8 payload * scales) vs kernel max|diff| "
              f"{lib_err:.3e}")
        for name, kernel, plain, lib, work, kname in (
                ("quantize_int8", lambda: qz.quantize_int8(x, block),
                 lambda: qz.quantize_int8_plain(x, block), None,
                 cost.quantize_cost(rows, length, block, 4),
                 "quantize_int8_kernel"),
                ("dequantize_int8",
                 lambda: qz.dequantize_int8(q, s, block, length),
                 lambda: qz.dequantize_int8_plain(q, s, block, length),
                 library, cost.dequantize_cost(rows, length, block, 4),
                 "dequantize_int8_kernel")):
            b_ms, b_by = cost.bound(*work)
            path = rows == N_NODES      # the path's shape: the JSON row
            eager_ms, lib_ms = (time_ms(torch, kernel, reps=reps), None) \
                if lib is None else paired_ms(torch, kernel, lib, reps=reps)
            t = {"ms": eager_ms,
                 "plain_ms": time_ms(torch, plain, reps=reps),
                 "library_ms": lib_ms,
                 "graph_ms": graph_ms(torch, kernel) if path else None,
                 "library_graph_ms": graph_ms(torch, lib)
                 if path and lib is not None else None,
                 "device_ms": prof.device_ms(kernel, kname, calls=reps),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "max_abs_err": errs[name],
                 "shape": f"({rows}, {length}) fp32, {block}-lane blocks"}
            print_times(name, t)
            if t["device_ms"] is not None:
                print(f"{'':15s} device rate "
                      f"{work[0] / t['device_ms'] / 1e9:.1f} TB/s")
            if path:
                out[name] = t
    against_library("dequantize_int8", out["dequantize_int8"],
                    "int8 payload * scales")
    # this phase's launches of the two TPU-contract kernels, the checks and
    # timings above: kept apart from the main path's count (the int8 round
    # runs the send instead, so that count is 0)
    for name in ("quantize_int8", "dequantize_int8"):
        out[name]["check_launches"] = getattr(qz, name).launches

    # the send at the path's message, one dead node, feedback on
    rows, length = N_NODES, 21_840
    flat = randn(rows, length, scale=0.3)
    res = randn(rows, length, scale=1e-3)
    live = torch.arange(rows, device=dev) != rows - 1
    b_ms, b_by = cost.bound(*cost.send_cost(rows, length))
    t = {"ms": time_ms(torch, lambda: qz.quantize_int8_ef(flat, res, live)),
         "plain_ms": time_ms(torch, lambda: qz.quantize_int8_ef_plain(
             flat, res, live)),
         "library_ms": None,
         "graph_ms": graph_ms(torch, lambda: qz.quantize_int8_ef(
             flat, res, live)),
         "library_graph_ms": None,
         "device_ms": prof.device_ms(lambda: qz.quantize_int8_ef(
             flat, res, live), "quantize_int8_ef_kernel"),
         "bound_ms": b_ms, "bound_by": b_by,
         "max_abs_err": errs["quantize_int8_ef"],
         "shape": f"flat, res ({rows}, {length}) fp32, one dead node, "
                  f"2048-lane blocks"}
    print_times("quantize_int8_ef", t)
    out["quantize_int8_ef"] = t
    return out


def phase_serve(torch, title: str, arch: str, counters: dict, want: dict,
                why: str, repeat: bool = False) -> dict:
    """Serve ``arch`` at its published widths at (SERVE_BATCH,
    SERVE_PROMPT, SERVE_GEN) in bf16 through ``launch.serve.generate``;
    ``counters`` are the kernel wrappers of its path, each of which must
    launch exactly ``want[name]`` times. With ``repeat``, a second serve
    from the same seed must give the same tokens."""
    phase(title)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.models import build, moe, transformer

    cfg = get_config(arch)
    kinds = [transformer._mixer_kind(cfg, k)
             for k in transformer.layer_kinds(cfg)]
    if cfg.is_encdec:
        kinds = ["encoder"] * cfg.encoder_layers + \
            ["decoder (self + cross)"] * (cfg.n_layers - cfg.encoder_layers)
    mix = ", ".join(f"{kinds.count(k)} {k}" for k in sorted(set(kinds)))
    extra = ""
    if cfg.mla is not None:
        m = cfg.mla
        extra += (f"; MLA kv_lora {m.kv_lora_rank}, qk {m.qk_nope_dim} + "
                  f"{m.qk_rope_dim} rope, v {m.v_head_dim}")
    if cfg.moe is not None:
        mc = cfg.moe
        extra += (f"; layers {cfg.first_k_dense}.. MoE: {mc.n_experts} "
                  f"experts top-{mc.top_k} + {mc.n_shared} shared, expert "
                  f"d_ff {mc.d_ff_expert}, capacity factor "
                  f"{mc.capacity_factor} ({moe.capacity(SERVE_PROMPT, mc)} "
                  f"slots an expert and row at the prompt), dense d_ff "
                  f"{cfg.dense_d_ff}")
    if cfg.is_encdec:
        extra += (f"; the prompt's {SERVE_PROMPT} positions as "
                  f"{SERVE_PROMPT // 2} source frames and "
                  f"{SERVE_PROMPT // 2} target tokens")
    print(f"{cfg.name}: {cfg.n_layers} layers ({mix}), d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, window {cfg.window}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype} compute, {cfg.param_dtype} "
          f"weights{extra}; batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
          f"{SERVE_GEN} tokens")
    # warm-up at the same widths (cuBLAS handles, the allocator's pools)
    serve.generate(cfg, batch=SERVE_BATCH, prompt_len=WARM_PROMPT, gen=2,
                   device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()     # what earlier phases hold

    for fn in counters.values():
        fn.launches = 0
    out = serve.generate(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                         gen=SERVE_GEN, device="cuda")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"launches: {launches} (expected {want}: {why})")
    check(launches == want, f"launches {launches}, want {want}")
    tokens, logits = out["tokens"], out["logits"]
    check(tuple(tokens.shape) == (SERVE_BATCH, SERVE_GEN),
          f"tokens {tuple(tokens.shape)}")
    check(bool(torch.isfinite(logits.float()).all()), "non-finite logits")
    print(f"prefill {out['prefill_s']:.4f} s ({SERVE_BATCH} x {SERVE_PROMPT} "
          f"tokens), decode {out['decode_s']:.4f} s for {SERVE_GEN - 1} "
          f"steps = {out['tok_per_s']:.2f} tok/s, peak device memory "
          f"{peak / 2**30:.3f} GiB ({peak} bytes); sample "
          f"{tokens[0, :8].tolist()}")
    if repeat:
        again = serve.generate(cfg, batch=SERVE_BATCH,
                               prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
                               device="cuda")
        same = torch.equal(again["tokens"], tokens)
        print(f"a second serve from the same seed: tokens "
              f"{'identical' if same else 'DIFFER'} ({tokens.numel()} "
              f"tokens); logits max|diff| "
              f"{err(again['logits'], out['logits']):.3e}")
        check(same, "two serves from the same seed gave different tokens")
        del again

    # where the time goes: one profiled prefill, then DECODE_PROFILE_STEPS
    # decode steps timed on the host clock and again under the profiler
    api = build(cfg, "cuda")
    rng = torch.Generator(device="cuda").manual_seed(1)
    params = serve.init_serving_params(api, rng)
    leaves = tree_leaves(params)
    print(f"parameters: {sum(t.numel() for t in leaves)}")
    # decode reads every weight each step (the table too: tied logits, or
    # the head); MoE layers every expert's, as the dispatch buffer holds
    # a slot of every expert
    step_bytes = sum(t.numel() * t.element_size() for t in leaves)
    if not cfg.tie_embeddings:
        emb = params["embed"]["embedding"]
        step_bytes -= emb.numel() * emb.element_size()
    floor_ms = step_bytes / cost.HBM_BYTES_PER_S * 1e3
    expert_bytes = sum(
        t.numel() * t.element_size() for layer in params.get("unit", [])
        for name, t in layer.get("moe", {}).items() if name.startswith("ew_"))
    print(f"a decode step reads {step_bytes / 1e9:.3f} GB of weights: at "
          f"least {floor_ms:.3f} ms at "
          f"{cost.HBM_BYTES_PER_S / 1e12:.2f} TB/s"
          + (f"; of it every expert's, {expert_bytes / 1e9:.3f} GB "
             f"({expert_bytes / cost.HBM_BYTES_PER_S * 1e3:.3f} ms)"
             if expert_bytes else ""))
    inputs = api.make_inputs(ShapeConfig("serve", SERVE_PROMPT, SERVE_BATCH,
                                         "prefill"), rng,
                             batch_override=SERVE_BATCH)
    base = inputs["tokens"].shape[1]     # the target prompt's length
    max_len = base + 2 * DECODE_PROFILE_STEPS + 1
    state = {}

    def prefill():
        state["logits"], state["cache"] = api.prefill(params, inputs,
                                                      max_len=max_len)
    traced = prof.trace(prefill)
    rows = traced["top"]
    if cfg.moe is not None:
        # what the served capacity drops: the same prefill again, each MoE
        # layer's routing counted beside it (moe_apply itself unchanged)
        drops, real = [], moe.moe_apply

        def counting(p, x, cfg_, mcfg, *model):
            r = moe.moe_route(p, x, cfg_, mcfg)
            drops.append(int((~r["keep"]).sum()))
            return real(p, x, cfg_, mcfg, *model)
        moe.moe_apply = counting
        try:
            prefill()
        finally:
            moe.moe_apply = real
        pairs = SERVE_BATCH * SERVE_PROMPT * cfg.moe.top_k
        print(f"(token, expert) pairs dropped past capacity in the prefill "
              f"at capacity factor {cfg.moe.capacity_factor}, per MoE layer "
              f"(of {pairs}): {drops}; {sum(drops)} in all")
    if not rows:
        print("prefill profile: no device time in the trace (not measured)")
    else:
        print(f"profile of one prefill: device busy "
              f"{traced['busy_ms']:.4f} ms of {traced['wall_ms']:.4f} wall, "
              f"idle {traced['idle']:.4f}; hand-written kernels' launches "
              f"read from the trace "
              f"{ {k: n for k, n in traced['launches'].items() if n} }; "
              f"top device operations (ms, launches):")
        for name, ms, calls in rows[:10]:
            print(f"   {ms:9.4f} ms  {calls:4d}x  {name[:90]}")

    def decode(start):
        tok = torch.argmax(state["logits"], -1)
        for i in range(DECODE_PROFILE_STEPS):
            state["logits"], state["cache"] = api.decode_step(
                params, tok, state["cache"], start + i)
            tok = torch.argmax(state["logits"], -1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode(base)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / DECODE_PROFILE_STEPS
    drows = prof.device_profile(lambda: decode(
        base + DECODE_PROFILE_STEPS), DECODE_PROFILE_STEPS)
    idle = None
    print(f"decode: {wall_ms:.4f} ms/step wall against the weights' floor "
          f"of {floor_ms:.4f} ms/step")
    if not drows:
        print("decode profile: no device time in the trace (not measured)")
    else:
        dbusy = sum(r[1] for r in drows)
        idle = 1 - dbusy / wall_ms
        print(f"decode, {DECODE_PROFILE_STEPS} steps: device busy "
              f"{dbusy:.4f} ms/step in {sum(r[2] for r in drows)} launches "
              f"vs {wall_ms:.4f} ms/step wall, idle share {idle:.3f}; top "
              f"device operations (ms/step, launches/step):")
        for name, ms, calls in drows[:8]:
            print(f"   {ms:9.4f} ms  {calls:4d}x  {name[:90]}")
    del params, state
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": out["prefill_s"],
            "tok_per_s": out["tok_per_s"], "peak_bytes": peak,
            "base_bytes": base_bytes, "prefill_traced": traced["launches"],
            "state_bytes": (sum(t.numel() * t.element_size()
                                for t in leaves), 0),
            "decode_idle_share": idle, "decode_ms": wall_ms,
            "decode_floor_ms": floor_ms}


def phase_served_correctness(torch, title: str, arch: str, counters: dict,
                             lock_cfg, lock_tol: float,
                             shape_noise: bool = False) -> None:
    """(a) fp32 teacher forcing of ``arch`` at full width and depth; (b)
    card against CPU in lockstep at ``lock_cfg``, held at ``lock_tol``.
    Both must launch every kernel of ``counters``. With ``shape_noise``,
    (a) also measures what the GEMMs' shapes alone change (see there).
    An encoder-decoder's prompt is its target tokens, over source frames
    of the same length (half the decoder-only prompt); a MoE's capacity
    factor in (a) is n_experts / top_k (see there)."""
    phase(title)
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build, encdec, moe, transformer

    def ran():
        return {name: fn.launches for name, fn in counters.items()}

    # (a) teacher forcing at full width and depth, in fp32 (same widths,
    # only the compute type differs): prefill (the kernels) and decode
    # (plain torch: the ring-buffer einsum, the one-token WKV step, MLA's
    # absorbed form, cross attention on the cached encoder K/V) against
    # apply's logits at the same positions. fp32 end to end (TF32 off):
    # held at tests/test_serve.py's 2e-4, room for summation order over the
    # layers (2.4e-5 measured on an H100 for recurrentgemma-2b), not for a
    # wrong band, ring or carried state.
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    prompt = TF_PROMPT // 2 if cfg.is_encdec else TF_PROMPT
    note = ""
    if cfg.moe is not None:
        # Teacher forcing holds only where no (token, expert) pair is
        # dropped: a drop depends on the row's length, which differs
        # between the prefill, each one-token step and apply. At the
        # config's factor random weights may overflow an expert's slots,
        # so (a) runs at capacity factor n_experts / top_k: cap >= S,
        # drop-free by construction, the same code path. (The served
        # prefill's drops at the real factor are counted in its phase.)
        mc = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            mc, capacity_factor=mc.n_experts / mc.top_k))
        caps = {n: moe.capacity(n, cfg.moe) for n in
                (1, prompt, prompt + TF_STEPS)}
        check(all(c >= n for n, c in caps.items()),
              f"capacities {caps} leave room for drops")
        note = (f", capacity factor {cfg.moe.capacity_factor:.4f} = "
                f"n_experts / top_k (the config's {mc.capacity_factor}: "
                f"drop-free, cap per row length {caps})")
    api = build(cfg, "cuda")
    rng = torch.Generator(device="cuda").manual_seed(2)
    params = api.init(rng)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt + TF_STEPS),
                           generator=rng, device="cuda")
    batch = {"tokens": tokens[:, :prompt]}
    if cfg.is_encdec:
        src = torch.randn((1, prompt, cfg.d_model), generator=rng,
                          device="cuda")
        batch["src_embeds"] = src

        def apply(t):
            return encdec.apply(cfg, params, src, t)
    else:
        def apply(t):
            return transformer.apply(cfg, params, t)
    for fn in counters.values():
        fn.launches = 0
    logits, cache = api.prefill(params, batch, max_len=prompt + TF_STEPS)
    served = [logits]
    for i in range(TF_STEPS):
        logits, cache = api.decode_step(params, tokens[:, prompt + i],
                                        cache, prompt + i)
        served.append(logits)
    full = apply(tokens)
    errs = [err(got, full[:, prompt - 1 + i])
            for i, got in enumerate(served)]
    scale = float(full[:, prompt - 1:].abs().max())
    print(f"(a) {cfg.name} fp32, batch 1, prompt {prompt}"
          f"{f' over {prompt} source frames' if cfg.is_encdec else ''}, "
          f"{TF_STEPS} decode steps{note}: max|served - apply| per "
          f"position {[f'{e:.3e}' for e in errs]} (logits up to "
          f"{scale:.3f}); launches {ran()}")
    bar = 2e-4
    if shape_noise:
        # A model that amplifies rounding (rwkv6-7b's random weights at
        # full depth) moves its logits when only the GEMMs' row counts
        # change (cuBLAS picks another kernel and summation order); in a
        # MoE such a change can also move a token past a near-tie of its
        # router. apply over the prompt alone has the prefill's shapes: the
        # prefill is held to it at 2e-4. apply over the prompt against
        # apply over the whole sequence, at the prompt's last position, is
        # the same computation with other shapes: that floor bounds the
        # decode steps, whose one-row GEMMs no apply shares. The carried
        # state itself is held exactly in phase 3c (the handoff check).
        short = apply(tokens[:, :prompt])[:, -1]
        same = err(served[0], short)
        floor = err(short, full[:, prompt - 1])
        bar = 2e-4 + 3 * floor
        print(f"    prefill vs apply over the prompt alone (same shapes): "
              f"{same:.3e}; apply vs apply, shapes only (the floor): "
              f"{floor:.3e}; decode held at 2e-4 + 3 x floor = {bar:.3e}")
        check(same <= 2e-4, f"prefill differs from apply over the same "
              f"prompt by {same}")
        del short
    check(max(errs) <= bar, f"served logits differ from apply by {errs}")
    check(all(n > 0 for n in ran().values()),
          "teacher forcing did not run the kernels")
    del params, cache, full, served, apply, batch
    torch.cuda.empty_cache()

    # (b) card (kernels) against CPU (plain versions) in lockstep at the
    # smoke widths. Each decode step starts both from the card's cache.
    # fp32 on both sides, held at the bar of the path's loosest kernel.
    cfg = lock_cfg
    api_c, api_g = build(cfg, "cpu"), build(cfg, "cuda")
    params_c = api_c.init(torch.Generator().manual_seed(3))
    params_g = tree_to(params_c, "cuda")
    gen = torch.Generator().manual_seed(4)
    batch_c = {"tokens": torch.randint(0, cfg.vocab_size,
                                       (LOCK_BATCH, LOCK_PROMPT),
                                       generator=gen)}
    if cfg.is_encdec:
        batch_c["src_embeds"] = torch.randn(
            (LOCK_BATCH, LOCK_PROMPT, cfg.d_model), generator=gen)
    batch_g = tree_to(batch_c, "cuda")
    max_len = LOCK_PROMPT + LOCK_STEPS + 1
    for fn in counters.values():
        fn.launches = 0
    lg, cg = api_g.prefill(params_g, batch_g, max_len=max_len)
    lc, cc = api_c.prefill(params_c, batch_c, max_len=max_len)
    worst = {"logits": err(lg.cpu(), lc),
             "cache": max(err(a.cpu(), b) for a, b in
                          zip(tree_leaves(cg), tree_leaves(cc)))}
    for i in range(LOCK_STEPS):
        tok = torch.argmax(lg, -1)
        lg, cg_next = api_g.decode_step(params_g, tok, cg, LOCK_PROMPT + i)
        lc, cc = api_c.decode_step(params_c, tok.cpu(), tree_to(cg, "cpu"),
                                   LOCK_PROMPT + i)
        cg = cg_next
        worst["logits"] = max(worst["logits"], err(lg.cpu(), lc))
        worst["cache"] = max(worst["cache"], max(
            err(a.cpu(), b) for a, b in zip(tree_leaves(cg),
                                            tree_leaves(cc))))
    print(f"(b) {cfg.name} ({cfg.n_layers} layers, window {cfg.window}), "
          f"batch {LOCK_BATCH}, prompt {LOCK_PROMPT}, {LOCK_STEPS} decode "
          f"steps, card vs CPU in lockstep: max|logits diff| "
          f"{worst['logits']:.3e}, max|cache diff| {worst['cache']:.3e} "
          f"(tol {lock_tol:g}); card launches {ran()}")
    check(worst["logits"] <= lock_tol and worst["cache"] <= lock_tol,
          f"card and CPU differ: {worst}")
    check(all(n > 0 for n in ran().values()),
          "the card side did not run the kernels")


def phase_simulated_training(torch) -> dict:
    phase("10. training through the wireless simulator on the card")
    from repro_torch.core import dpsgd
    from repro_torch.core.compression import quantize_int8_rows
    from repro_torch.data import SyntheticFashion
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import quantize as qz
    from repro_torch.models import cnn
    from repro_torch.sim import (WirelessSimulator, get_scenario,
                                 simulate_dpsgd_cnn)

    counters = {"quantize_int8_ef": qz.quantize_int8_ef,
                "quantize_int8": qz.quantize_int8,
                "dequantize_int8": qz.dequantize_int8,
                "gossip_mix_q8": gm.gossip_mix_q8_rows,
                "gossip_mix": gm.gossip_mix_rows}
    t0 = time.perf_counter()
    ds = SyntheticFashion(n_train=N_TRAIN, n_test=N_TEST, seed=0)
    print(f"data: {N_TRAIN} train / {N_TEST} test images in "
          f"{time.perf_counter() - t0:.1f}s")
    # warm-up (cuDNN plans, vmap) at the same widths, outside the counted runs
    simulate_dpsgd_cnn(get_scenario("compressed_int8"), epochs=1,
                       n_train=1200, n_test=300, device="cuda")
    torch.cuda.synchronize()

    # the first SIM_CPU_ROUNDS compressed steps of the graphed run are
    # captured (the card's inputs and outputs) for the lockstep rerun on
    # the CPU below
    captured = []
    builders = {name: getattr(dpsgd, name) for name in (
        "make_dpsgd_step", "make_dpsgd_masked_step",
        "make_dpsgd_compressed_step")}
    factory = builders["make_dpsgd_compressed_step"]

    def capturing(*args, **kw):
        step = factory(*args, **kw)

        def run(params, batch, w, live, res):
            out = step(params, batch, w, live, res)
            if len(captured) < SIM_CPU_ROUNDS:
                captured.append(((params, batch, w, live, res), out))
            return out
        run.prepare = step.prepare
        return run

    # the "before" run: each builder returns its eager body (a plain
    # function, which simulate_dpsgd_cnn calls without a capture), for the
    # comparison only
    eager = {
        "make_dpsgd_step": lambda loss_fn, config=dpsgd.DPSGDConfig(): (
            lambda p, b, w: dpsgd.dpsgd_step(loss_fn, p, b, w, config)),
        "make_dpsgd_masked_step":
            lambda loss_fn, config=dpsgd.DPSGDConfig(): (
                lambda p, b, w, live: dpsgd.dpsgd_masked_step(
                    loss_fn, p, b, w, live, config)),
        "make_dpsgd_compressed_step":
            lambda loss_fn, quant, config=dpsgd.DPSGDConfig(): (
                lambda p, b, w, live, res: dpsgd.dpsgd_masked_compressed_step(
                    loss_fn, p, b, w, live, res, quant, config))}

    out = {}
    for name, variant in (("compressed_int8", "eager"),
                          ("compressed_int8", "graphed"),
                          ("static", "eager"), ("static", "graphed")):
        label = f"{name} ({variant})"
        cfg = get_scenario(name)
        patch = dict(eager) if variant == "eager" else \
            {"make_dpsgd_compressed_step": capturing}
        for attr, fn in patch.items():
            setattr(dpsgd, attr, fn)
        try:
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            trace, params = simulate_dpsgd_cnn(
                cfg, epochs=SIM_EPOCHS, ds=ds, measure_compute=True,
                device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
        finally:
            for attr, fn in builders.items():
                setattr(dpsgd, attr, fn)
        s = trace.summary()
        rounds = s["rounds"]
        compressed = cfg.payload.mode == "int8"
        want = ({"quantize_int8_ef": rounds, "quantize_int8": 0,
                 "dequantize_int8": 0, "gossip_mix_q8": rounds,
                 "gossip_mix": 0} if compressed else
                {"quantize_int8_ef": 0, "quantize_int8": 0,
                 "dequantize_int8": 0, "gossip_mix_q8": 0,
                 "gossip_mix": rounds})
        print(f"{label}: launches {launches} (expected {want})")
        check(launches == want, f"{label}: launches {launches}, want {want}")
        check(rounds == SIM_EPOCHS * N_TRAIN // N_NODES // 25,
              f"{label}: {rounds} rounds")
        check(all(np.isfinite(r.loss) for r in trace.records),
              f"{label}: non-finite loss")
        check(all(bool(torch.isfinite(x).all())
                  for x in dpsgd._leaves(params)),
              f"{label}: non-finite parameters")
        check(s["final_acc"] is not None and 0.0 <= s["final_acc"] <= 1.0,
              f"{label}: accuracy {s['final_acc']}")

        # the communication plane: the CPU simulator, charged the card's
        # measured compute per round (fading blocks follow the simulated
        # clock), must realize the very same rounds
        computes = [r.t_compute_s for r in trace.records]
        replay = WirelessSimulator(cfg).run(
            rounds, lambda ctx: {"compute_s": computes[ctx.round]})
        fields = ("round", "n_live", "t_start_s", "t_comm_s", "t_end_s",
                  "lam_planned", "lam_effective", "feasible",
                  "intended_links", "outage_links", "retx_packets",
                  "delivered_frac", "replanned", "mean_drift", "wire_bits",
                  "payload_mode")
        diff = [(a.round, f) for a, b in zip(trace.records, replay.records)
                for f in fields if getattr(a, f) != getattr(b, f)]
        print(f"{label}: communication fields of {rounds} rounds equal to the "
              f"CPU simulator's: {not diff}")
        check(not diff and len(replay.records) == rounds,
              f"{label}: the trace's communication differs from the CPU's at "
              f"{diff[:5]}")
        t_plan = time.perf_counter()
        sim = WirelessSimulator(cfg)           # the initial Algorithm 2 plan
        t_sim = time.perf_counter()
        sim.run(rounds)
        sim_ms = (time.perf_counter() - t_sim) * 1e3 / rounds
        plan_s = t_sim - t_plan
        step_ms = s["total_compute_s"] * 1e3 / rounds
        wall_ms = wall * 1e3 / rounds
        print(f"{label}: {rounds} rounds, simulated {s['t_end_s']:.4f} s "
              f"(communication {s['total_comm_s']:.4f} s + the card's "
              f"measured compute {s['total_compute_s']:.4f} s), outage "
              f"{s['outage_rate']:.4f}, final accuracy {s['final_acc']:.4f}, "
              f"loss {trace.records[0].loss:.4f} -> "
              f"{trace.records[-1].loss:.4f}")
        print(f"{label}: host {wall_ms:.4f} ms per round = simulator "
              f"{sim_ms:.4f} (driver-less run, after a {plan_s:.4f} s "
              f"initial plan) + step {step_ms:.4f} (synchronized) + the rest "
              f"{wall_ms - sim_ms - step_ms:.4f} (batch gather, evaluation "
              f"every {cfg.eval_every_rounds} rounds on {N_TEST} images)")
        split = {"host_ms": wall_ms, "step_ms": step_ms, "sim_ms": sim_ms}
        out.setdefault(name, {})[variant] = split
        if variant == "graphed":
            out[name]["launches"] = launches
    out["ds"] = ds
    for name in ("compressed_int8", "static"):
        e, g = out[name]["eager"], out[name]["graphed"]
        print(f"{name}: host ms per round graphed {g['host_ms']:.4f} vs "
              f"eager {e['host_ms']:.4f} "
              f"({'below' if g['host_ms'] < e['host_ms'] else 'NOT below'});"
              f" step {g['step_ms']:.4f} vs {e['step_ms']:.4f} ms")

    # the first compressed rounds again on the CPU (plain versions), in
    # lockstep: each from the card's input state
    check(len(captured) == SIM_CPU_ROUNDS, f"captured {len(captured)} rounds")
    to_cpu = lambda t: dpsgd._tree_map(lambda x: x.cpu(), t)  # noqa: E731
    step = factory(cnn.cnn_loss, get_scenario("compressed_int8").payload,
                   dpsgd.DPSGDConfig(eta=0.05))    # simulate_dpsgd_cnn's eta
    worst = {"loss": 0.0, "params": 0.0, "residuals": 0.0}
    for (params, batch, w, live, res), (p_g, r_g, l_g) in captured:
        p_c, r_c, l_c = step(to_cpu(params), to_cpu(batch), w, live.cpu(),
                             to_cpu(res))
        worst["loss"] = max(worst["loss"], err(l_g.cpu(), l_c))
        worst["residuals"] = max(worst["residuals"], max(
            err(a.cpu(), b) for a, b in zip(dpsgd._leaves(r_g),
                                            dpsgd._leaves(r_c))))
        worst["params"] = max(worst["params"], max(
            err(a.cpu(), b) for a, b in zip(dpsgd._leaves(p_g),
                                            dpsgd._leaves(p_c))))

        def carried(p, e):
            return torch.cat([(a + b).reshape(len(l_c), -1) for a, b in
                              zip(dpsgd._leaves(p), dpsgd._leaves(e))], 1)
        q_g, s_g = quantize_int8_rows(carried(params, res))
        q_c, s_c = quantize_int8_rows(carried(to_cpu(params), to_cpu(res)))
        check(torch.equal(q_g.cpu(), q_c) and torch.equal(s_g.cpu(), s_c),
              "int8 payload or scales differ card vs CPU")
    print(f"compressed_int8, first {SIM_CPU_ROUNDS} rounds card vs CPU in "
          f"lockstep: q and scales bit-equal, max|loss diff| "
          f"{worst['loss']:.3e}, max|param diff| {worst['params']:.3e}, "
          f"max|residual diff| {worst['residuals']:.3e}")
    check(worst["loss"] <= 1e-4, f"card and CPU losses differ: {worst}")
    check(worst["params"] <= TOL_FP32 and worst["residuals"] <= TOL_FP32,
          f"card and CPU parameters or residuals differ: {worst}")
    return out


def phase_train_on_trace(torch, simulated: dict) -> dict:
    phase("11. train-on-trace on the card: Monte-Carlo families over "
          "precomputed traces")
    from repro_torch.core import dpsgd
    from repro_torch.core.compression import quantize_int8_rows
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import quantize as qz
    from repro_torch.sim import (batch as tb, get_scenario, precompute_traces,
                                 simulate_dpsgd_cnn, train_cnn_on_traces)

    ds = simulated["ds"]
    dev = torch.device("cuda")
    counters = {"quantize_int8_ef": qz.quantize_int8_ef,
                "quantize_int8": qz.quantize_int8,
                "dequantize_int8": qz.dequantize_int8,
                "gossip_mix_q8": gm.gossip_mix_q8_rows,
                "gossip_mix": gm.gossip_mix_rows}
    rounds = SIM_EPOCHS * N_TRAIN // N_NODES // 25
    kw = dict(epochs=SIM_EPOCHS, ds=ds, n_test=N_TEST, device="cuda")

    def counted(fn, *args, **kwargs):
        """``fn`` with every counter set to 0 just before and read just
        after, and its wall seconds (synchronised)."""
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, \
            {k: c.launches for k, c in counters.items()}

    # the family step's first rounds, recorded for the CPU rerun in (d)
    recorded = []
    family_step = tb._family_step

    def record(step, args, out):
        if len(recorded) < FAMILY_CPU_ROUNDS:
            recorded.append((step, args, out))
    recording = tapped(family_step, record, keep_args=True)

    # the loop alone: train_on_traces with its wall seconds (and the
    # device inputs (a) built, which (e) replays)
    loop_s, loop_args = [], []
    train_on_traces = tb.train_on_traces

    def timed(*args, **kwargs):
        loop_args.append((args, kwargs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_on_traces(*args, **kwargs)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t0)
        return out

    # (a) a family of FAMILY_INT8 seeds of compressed_int8
    cfgs = [get_scenario("compressed_int8", seed=s)
            for s in range(FAMILY_INT8)]
    t0 = time.perf_counter()
    traces = precompute_traces(cfgs, rounds)
    pre_s = time.perf_counter() - t0
    # warm-up at the same family width (the graph's capture, cuDNN plans,
    # the evaluation's vmap), outside the counted run
    train_cnn_on_traces(cfgs, epochs=1, n_train=1200, n_test=300,
                        device="cuda")
    step = next(v for k, v in tb._STEPS.items() if k[0] is tb._cnn_loss
                and k[2] == cfgs[0].payload)
    captures = step.signatures
    torch.cuda.reset_peak_memory_stats()
    tb._family_step, tb.train_on_traces = recording, timed
    try:
        (traces_a, out_a), wall_a, launches = counted(
            train_cnn_on_traces, cfgs, trace_batch=traces, **kw)
    finally:
        tb._family_step, tb.train_on_traces = family_step, train_on_traces
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"quantize_int8_ef": FAMILY_INT8 * rounds, "quantize_int8": 0,
            "dequantize_int8": 0, "gossip_mix_q8": FAMILY_INT8 * rounds,
            "gossip_mix": 0}
    print(f"(a) compressed_int8 x {FAMILY_INT8} seeds x {rounds} rounds: "
          f"launches {launches} (expected {want})")
    check(launches == want, f"(a) launches {launches}, want {want}")
    check(step.signatures == captures == 1,
          f"(a) {step.signatures} graphs after the run, {captures} before")
    check(np.isfinite(out_a["losses"]).all(), "(a) non-finite loss")
    check(all(bool(torch.isfinite(x).all()) for p in out_a["final_params"]
              for x in dpsgd._leaves(p)), "(a) non-finite parameters")
    acc = out_a["acc"]
    check(acc.shape == (FAMILY_INT8, len(out_a["eval_rounds"]))
          and ((0.0 <= acc) & (acc <= 1.0)).all(), f"(a) accuracies {acc}")
    check(np.array_equal(out_a["t_acc_s"],
                         traces.t_end_s[:, out_a["eval_rounds"]]),
          "(a) t_acc_s is not the traces' t_end_s at eval_rounds")
    loop_ms = loop_s[0] * 1e3 / rounds
    print(f"(a) losses {out_a['losses'][:, 0].round(4).tolist()} -> "
          f"{out_a['losses'][:, -1].round(4).tolist()}, final accuracy "
          f"{acc[:, -1].round(4).tolist()}, simulated "
          f"{traces.t_end_s[:, -1].round(4).tolist()} s")

    # (b) a family of FAMILY_CHAOS seeds of fault_chaos, watchdog armed
    chaos = [get_scenario("fault_chaos", seed=s) for s in range(FAMILY_CHAOS)]
    (traces_b, out_b), wall_b, launches_b = counted(
        train_cnn_on_traces, chaos, **kw)
    want_b = {"quantize_int8_ef": 0, "quantize_int8": 0,
              "dequantize_int8": 0, "gossip_mix_q8": 0,
              "gossip_mix": FAMILY_CHAOS * rounds}
    crashed = int((traces_b.active != traces_b.live).sum())
    rb = out_b["rollbacks"]
    print(f"(b) fault_chaos x {FAMILY_CHAOS} seeds: launches {launches_b} "
          f"(expected {want_b}), {crashed} crashed (live, not active) node "
          f"rounds, rollbacks {None if rb is None else rb.shape} with "
          f"{0 if rb is None else int(rb.sum())} events, {wall_b:.2f} s")
    check(launches_b == want_b, f"(b) launches {launches_b}, want {want_b}")
    check(rb is not None and rb.shape == (FAMILY_CHAOS, rounds, N_NODES),
          f"(b) rollbacks {None if rb is None else rb.shape}")
    check(crashed > 0 and np.isfinite(out_b["losses"]).all(),
          "(b) no crash in play or a non-finite loss")

    # (c) the loop at S = 1 against the per-round driver, same card, same
    # call (compute charged at compute_s_per_round: one trace each)
    parity = {}
    for name in ("static", "churn"):
        cfg = get_scenario(name)
        trace, _ = simulate_dpsgd_cnn(cfg, epochs=SIM_EPOCHS, ds=ds,
                                      n_test=N_TEST, device="cuda")
        tr_c, out_c = train_cnn_on_traces([cfg], **kw)
        driver = np.array([r.loss for r in trace.records])
        diff = np.abs(out_c["losses"][0] - driver)
        agree = int(np.argmax(diff > 1e-5)) if (diff > 1e-5).any() \
            else len(diff)
        same_live = [r.n_live for r in trace.records] == \
            tr_c.live[0].sum(-1).tolist()
        print(f"(c) {name}: loop against driver, max|mean loss diff| over "
              f"the first {PARITY_ROUNDS} rounds "
              f"{diff[:PARITY_ROUNDS].max():.3e}, the first {agree} of "
              f"{len(diff)} rounds within 1e-5, max over all "
              f"{diff.max():.3e}; live counts equal: {same_live}; final "
              f"node {tr_c.live[0, -1].sum()}")
        check(same_live and agree >= PARITY_ROUNDS,
              f"(c) {name}: the loop leaves the driver at round {agree}")
        parity[name] = {"first_rounds_max_diff":
                        float(diff[:PARITY_ROUNDS].max()),
                        "rounds_within": agree, "max_diff": float(diff.max())}

    # (d) the first recorded rounds of (a) again on the CPU, in lockstep
    check(len(recorded) == FAMILY_CPU_ROUNDS,
          f"(d) recorded {len(recorded)} rounds")
    to_cpu = lambda t: None if t is None else dpsgd._tree_map(  # noqa: E731
        lambda x: x.cpu(), t)
    worst = {"loss": 0.0, "params": 0.0, "residuals": 0.0}
    for step_r, args, out in recorded:
        cpu = step_r(*(to_cpu(a) for a in args))     # CPU: the eager body
        worst["loss"] = max(worst["loss"], err(out["losses"].cpu(),
                                               cpu["losses"]))
        worst["params"] = max(worst["params"], max(
            err(a.cpu(), b) for a, b in zip(dpsgd._leaves(out["params"]),
                                            dpsgd._leaves(cpu["params"]))))
        worst["residuals"] = max(worst["residuals"], max(
            err(a.cpu(), b) for a, b in zip(dpsgd._leaves(out["res"]),
                                            dpsgd._leaves(cpu["res"]))))
        params, res = args[0], args[1]
        carried = torch.cat([(a + b).reshape(FAMILY_INT8 * N_NODES, -1)
                             for a, b in zip(dpsgd._leaves(params),
                                             dpsgd._leaves(res))], 1)
        q_g, s_g = quantize_int8_rows(carried)
        q_c, s_c = quantize_int8_rows(carried.cpu())
        check(torch.equal(q_g.cpu(), q_c) and torch.equal(s_g.cpu(), s_c),
              "(d) int8 payload or scales differ card vs CPU")
    print(f"(d) first {FAMILY_CPU_ROUNDS} family rounds card vs CPU in "
          f"lockstep: q and scales bit-equal, max|loss diff| "
          f"{worst['loss']:.3e}, max|param diff| {worst['params']:.3e}, "
          f"max|residual diff| {worst['residuals']:.3e}")
    check(worst["loss"] <= 1e-4, f"(d) card and CPU losses differ: {worst}")
    check(worst["params"] <= TOL_FP32 and worst["residuals"] <= TOL_FP32,
          f"(d) card and CPU parameters or residuals differ: {worst}")

    # (e) the round loop of (a) again, its inputs on the card, under the
    # sync debug mode: a host read inside the loop raises
    (loss_fn, params0, *arrays, batches, config), loop_kw = loop_args[0]
    arrays = [torch.as_tensor(a, device=dev) for a in arrays]
    loop_kw["active_seq"] = torch.as_tensor(loop_kw["active_seq"], device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, losses_e, _ = tb.train_on_traces(loss_fn, params0, *arrays,
                                            batches, config, **loop_kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    live = traces.live
    mean_e = np.where(live, losses_e.cpu().numpy().astype(np.float64),
                      0.0).sum(-1) / live.sum(-1)
    diff_e = np.abs(mean_e - out_a["losses"])
    print(f"(e) the round loop of (a) under set_sync_debug_mode('error'): "
          f"no host synchronisation; its mean losses against (a)'s: "
          f"max|diff| {diff_e[:, :PARITY_ROUNDS].max():.3e} over the first "
          f"{PARITY_ROUNDS} rounds, {diff_e.max():.3e} over all, bit-equal "
          f"{np.array_equal(mean_e, out_a['losses'])}")
    check(np.isfinite(mean_e).all() and mean_e.shape == live.shape[:2],
          f"(e) the replayed loop's losses: {mean_e.shape}, finite "
          f"{np.isfinite(mean_e).all()}")

    # (f) measurements: the family's graph replayed alone (device ms per
    # round) against the loop's host ms per round
    entry = next(iter(step._entries.values()))
    # is one replay repeatable? the same static inputs, replayed twice
    entry.graph.replay()
    first_out = [f.clone() for f in entry.outs]
    entry.graph.replay()
    repeat = max(err(a, b) for a, b in zip(first_out, entry.outs))
    print(f"(e) one family round replayed twice from the same inputs: "
          f"max|diff| of its outputs {repeat:.3e}")
    replay_ms = time_ms(torch, entry.graph.replay, reps=20, rounds=5,
                        warmup=3)
    driver_ms = simulated["compressed_int8"]["graphed"]["host_ms"]
    per_trace = loop_ms / FAMILY_INT8
    idle = 1.0 - replay_ms / loop_ms
    print(f"(f) family of {FAMILY_INT8}: precompute {pre_s:.4f} s, "
          f"train_cnn_on_traces {wall_a:.4f} s wall (the loop "
          f"{loop_s[0]:.4f} s: {loop_ms:.4f} host ms per round, "
          f"{per_trace:.4f} per round per trace, against phase 10's "
          f"graphed driver {driver_ms:.4f} ms per round); one replay of the "
          f"family's round {replay_ms:.4f} ms on the card, idle share of the "
          f"loop {idle:.4f}; graph captures (signatures) {step.signatures}; "
          f"peak memory {peak:.3f} GiB")
    return {"launches": launches, "launches_b": launches_b,
            "parity": parity, "lockstep": worst, "loop_ms": loop_ms,
            "per_trace_ms": per_trace, "replay_ms": replay_ms,
            "idle": idle, "wall_s": wall_a, "peak_gib": peak,
            "driver_ms": driver_ms, "repeat": repeat}


def phase_flash_backward(torch) -> dict:
    phase("3e. flash_attention_bwd against its plain version")
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    tol = {f32: TOL_FLASH_FP32, bf16: TOL_BF16}
    # phase 16's shape, phase 17's (the smoke widths, fp32), then edge
    # shapes: windowed D 256 with 10 q heads on 1 kv head (GQA summed in
    # the kernel), non-causal T != S both ways at D 64, D 192, ragged S
    lock = (N_NODES * TRAIN_BATCH, LOCK_TRAIN_SEQ, LOCK_TRAIN_SEQ, 4, 4, 16,
            True, 0)
    edges = [(2, 1000, 1000, 10, 1, 256, True, 300),
             (2, 100, 333, 16, 16, 64, False, 0),
             (2, 333, 100, 16, 16, 64, False, 0),
             (1, 300, 300, 16, 16, 192, True, 0),
             (2, 77, 77, 4, 2, 80, True, 0),
             (2, 129, 129, 4, 1, 128, True, 0)]
    cases = [(*BWD_MAIN, bf16), (*BWD_MAIN, f32), (*QWEN_BWD, bf16),
             (*lock, f32)] + [(*e, dt) for e in edges for dt in (bf16, f32)]
    worst, worst_fwd, out, qwen_fwd = 0.0, 0.0, {}, None
    for b, s, t, hq, hkv, d, causal, window, dtype in cases:
        q, do = (torch.randn((b, s, hq, d), generator=gen, device=dev)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((b, t, hkv, d), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        what = (f"({b},{s}x{t},{hq}/{hkv},{d}) causal={causal} w={window} "
                f"{str(dtype)[6:]}")
        # the forward instance that writes lse, against the plain version
        o, lse = fa._forward(q, k, v, causal, window, True)
        o_p, lse_p = fa.flash_attention_plain(q, k, v, causal=causal,
                                              window=window, return_lse=True)
        torch.cuda.synchronize()
        check(lse.shape == lse_p.shape and bool(torch.equal(
            torch.isfinite(lse), torch.isfinite(lse_p))),
              f"flash_attention forward {what}: lse {lse.shape}")
        live = torch.isfinite(lse_p)
        e_o, e_l = err(o, o_p), err(lse[live], lse_p[live])
        line = f"out max|err| {e_o:.3e} (tol {tol[dtype]:g})"
        check(e_o <= tol[dtype], f"flash_attention forward {what}: out "
              f"max|err| {e_o} > {tol[dtype]}")
        if dtype == bf16:
            re = row_err(o, o_p)
            line += f", row |err|/|want| {re:.3e} (tol {TOL_FLASH_ROW:g})"
            check(re <= TOL_FLASH_ROW, f"flash_attention forward {what}: "
                  f"row error {re} > {TOL_FLASH_ROW}")
        line += f"; lse max|err| {e_l:.3e} (tol {TOL_LSE:g})"
        check(e_l <= TOL_LSE, f"flash_attention forward {what}: lse "
              f"max|err| {e_l} > {TOL_LSE}")
        print(f"flash_attention forward with lse {what:48s} {line}")
        worst_fwd = max(worst_fwd, e_o)
        # the backward on the kernel's forward and on the plain one, each
        # against the plain version's formulas summed in float64 on the
        # same o and lse (two fp32 orders of a key's g x S-term sums differ
        # by tens of ulps)
        for src, (oo, ll) in (("kernel", (o, lse)), ("plain", (o_p, lse_p))):
            got = fa.flash_attention_bwd(q, k, v, oo, ll, do, causal=causal,
                                         window=window)
            if src == "kernel":     # no atomics: a second call bit-equal
                again = fa.flash_attention_bwd(q, k, v, oo, ll, do,
                                               causal=causal, window=window)
                check(all(bool(torch.equal(a, b_)) for a, b_ in
                          zip(got, again)), f"flash_attention_bwd {what}: "
                      "two calls differ")
                del again
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_plain(q, k, v, oo, ll, do,
                                                causal=causal, window=window,
                                                acc_dtype=torch.float64)
            for name, g, w_ in zip(("dq", "dk", "dv"), got, want):
                check(g.shape == w_.shape and g.dtype == w_.dtype,
                      f"flash_attention_bwd {what} {name}: {g.shape}/"
                      f"{g.dtype}")
                e = err(g, w_)
                worst = max(worst, e)
                line = f"max|err| {e:.3e} (tol {tol[dtype]:g})"
                if (b, s, t, hq, hkv, d, causal, window) == QWEN_BWD:
                    # GQA 6:1 sums 6 heads' 512 queries into a key's dk,
                    # dv: |dv| reaches 4-13, where one bf16 ulp (2^-5 and
                    # up) exceeds 3e-2; an element is held within 3e-2 or
                    # one ulp of the oracle's value, whichever is larger
                    ex = bf16_ulp_excess(torch, g, w_, tol[dtype])
                    line += f", past max(tol, 1 ulp): {ex}"
                    check(ex == 0, f"flash_attention_bwd {what} {name} "
                          f"({src} forward): {ex} elements beyond "
                          f"max({tol[dtype]}, one bf16 ulp)")
                else:
                    check(e <= tol[dtype], f"flash_attention_bwd {what} "
                          f"{name} ({src} forward): max|err| {e} > "
                          f"{tol[dtype]}")
                if dtype == bf16:
                    # dq of a query with one live key (the first, causal)
                    # is 0 exactly: its softmax has no gradient, both sides
                    # hold rounding noise with no norm to be held against;
                    # those rows are held by the absolute bar only
                    first = 1 if name == "dq" and causal else 0
                    re = row_err(g[:, first:], w_[:, first:])
                    line += (f", row |err|/|want| {re:.3e} "
                             f"(tol {TOL_FLASH_ROW:g})")
                    check(re <= TOL_FLASH_ROW, f"flash_attention_bwd {what} "
                          f"{name} ({src} forward): row error {re} > "
                          f"{TOL_FLASH_ROW}")
                print(f"flash_attention_bwd {what:48s} {name} on the {src} "
                      f"forward: {line}")
            del got, want
        del o_p, lse_p

        # times: the kernel, its plain version, SDPA's forward and backward
        # (autograd, apart), the bound of 5 products a pair
        def kernel():
            return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                          window=window)
        qq, kk, vv = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        mask = None
        if window or (causal and s != t):
            qpos = torch.arange(s, device=dev)[:, None]
            kpos = torch.arange(t, device=dev)[None, :]
            mask = torch.ones((s, t), dtype=torch.bool, device=dev)
            if causal:
                mask &= kpos <= qpos
            if window:
                mask &= qpos - kpos < window

        def sdpa():
            return F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=hq != hkv)
        lib_out = sdpa()
        dot = do.transpose(1, 2)
        big = b * s * hq * d >= 1 << 22
        reps = dict(reps=3, rounds=3, warmup=1) if big else \
            dict(reps=20, rounds=3, warmup=3)
        elt, peak = (2, cost.BF16_FLOPS) if dtype == bf16 \
            else (4, cost.FP32_FLOPS)
        nbytes, flops = cost.bwd_cost(b, s, t, hq, hkv, d, causal, window,
                                      elt)
        b_ms, b_by = cost.bound(nbytes, flops, peak)
        t_ = {"ms": time_ms(torch, kernel, **reps),
              "device_ms": prof.device_ms(kernel, "flash_bwd", calls=3),
              "graph_ms": graph_ms(torch, kernel, reps=3 if big else 20,
                                   rounds=3),
              "plain_ms": time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                  q, k, v, o, lse, do, causal=causal, window=window),
                  reps=1, rounds=3, warmup=1),
              "library_fwd_ms": time_ms(torch, sdpa, **reps),
              "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                  lib_out, (qq, kk, vv), dot, retain_graph=True), **reps),
              # every device operation of SDPA's backward call (its
              # kernels, pre-pass and conversions), beside the kernel's
              "library_device_ms": prof.device_ms(
                  lambda: torch.autograd.grad(
                      lib_out, (qq, kk, vv), dot, retain_graph=True), "",
                  calls=3),
              "bound_ms": b_ms, "bound_by": b_by,
              "shape": f"q, do ({b},{s},{hq},{d}) k, v ({b},{t},{hkv},{d}) "
                       f"{str(dtype)[6:]}, "
                       f"{'causal' if causal else 'non-causal'}, "
                       f"window {window}"}
        dev_t = t_["device_ms"] if t_["device_ms"] is not None else t_["ms"]
        dms = "not measured" if t_["device_ms"] is None \
            else f"{t_['device_ms']:.4f} ms"
        lib_d = t_["library_device_ms"]
        lib_dev = "not measured" if lib_d is None else f"{lib_d:.4f} ms"
        lib_ratio = "not measured" if lib_d is None or \
            t_["device_ms"] is None else f"{t_['device_ms'] / lib_d:.2f}x"
        print(f"flash_attention_bwd {t_['shape']}: {t_['ms']:.4f} ms/call "
              f"(device {dms}, in a graph {t_['graph_ms']:.4f} ms) | plain "
              f"{t_['plain_ms']:.4f} ms | library (SDPA, autograd) forward "
              f"{t_['library_fwd_ms']:.4f} ms, backward "
              f"{t_['library_ms']:.4f} ms (device {lib_dev}): the kernel "
              f"{t_['ms'] / t_['library_ms']:.2f}x its time eagerly, "
              f"{lib_ratio} on the device | bound "
              f"{t_['bound_ms']:.4f} ms ({t_['bound_by']}; {flops:.4e} "
              f"flops, {nbytes:.4e} bytes), {t_['bound_ms'] / dev_t * 100:.2f}"
              f" % of it, {flops / dev_t / 1e9:.2f} TFLOP/s")
        if (b, s, t, hq, hkv, d, causal, window) == QWEN_BWD:
            qwen_fwd = flash_forward_times(torch, q, k, v, causal, window)
        if (b, s, t, hq, hkv, d, causal, window) == BWD_MAIN:
            # the call's device operations one by one
            for name_, ms_, n_ in prof.device_profile(kernel, 1):
                if "flash_bwd" in name_:
                    print(f"   {name_[:72]}: {ms_:.4f} ms x {n_}")
        out[(b, s, t, hq, hkv, d, causal, window, str(dtype)[6:])] = t_
        del q, k, v, o, lse, do, qq, kk, vv, lib_out
    print(f"the forward with lse at every shape above: out max|err| "
          f"{worst_fwd:.3e}; the backward: max|err| {worst:.3e}")
    main = out[(*BWD_MAIN, "bfloat16")]
    fields = ("ms", "device_ms", "graph_ms", "plain_ms", "library_ms",
              "library_device_ms", "library_fwd_ms", "bound_ms", "bound_by",
              "shape")
    row = dict(main, max_abs_err=worst,
               fp32={f: out[(*BWD_MAIN, "float32")][f] for f in fields},
               qwen2_vl_train={f: out[(*QWEN_BWD, "bfloat16")][f]
                               for f in fields})
    return {"flash_attention_bwd": row,
            "flash_attention_qwen2_vl_train": qwen_fwd}


def flash_forward_times(torch, q, k, v, causal: bool, window: int) -> dict:
    """The forward that training runs (it writes lse) at one shape: the
    kernel's call, device and graph times, its plain version's, SDPA's
    forward (no autograd; ``enable_gqa``) eagerly and on the device, and
    the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qq, kk, vv = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def kernel():
        return fa._forward(q, k, v, causal, window, True)

    def sdpa():
        with torch.no_grad():
            return F.scaled_dot_product_attention(
                qq, kk, vv, is_causal=causal, enable_gqa=hq != hkv)
    check(not window, "flash_forward_times: no window (SDPA's causal mask)")
    elt, peak = (2, cost.BF16_FLOPS) if q.dtype == torch.bfloat16 \
        else (4, cost.FP32_FLOPS)
    nbytes, flops = cost.flash_cost(b, s, hq, hkv, d, window, elt)
    b_ms, b_by = cost.bound(nbytes, flops, peak)
    t_ = {"ms": time_ms(torch, kernel, reps=20, rounds=3, warmup=3),
          "device_ms": prof.device_ms(kernel, "flash_attention", calls=3),
          "graph_ms": graph_ms(torch, kernel, reps=20, rounds=3),
          "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
              q, k, v, causal=causal, window=window, return_lse=True),
              reps=1, rounds=3, warmup=1),
          "library_ms": time_ms(torch, sdpa, reps=20, rounds=3, warmup=3),
          "library_device_ms": prof.device_ms(sdpa, "", calls=3),
          "bound_ms": b_ms, "bound_by": b_by,
          "shape": f"q ({b},{s},{hq},{d}) k, v ({b},{s},{hkv},{d}) "
                   f"{str(q.dtype)[6:]}, "
                   f"{'causal' if causal else 'non-causal'}, with lse"}
    dev_t = t_["device_ms"] if t_["device_ms"] is not None else t_["ms"]
    print(f"flash_attention forward {t_['shape']}: {t_['ms']:.4f} ms/call "
          f"(device {t_['device_ms']}, in a graph {t_['graph_ms']:.4f} ms) | "
          f"plain {t_['plain_ms']:.4f} ms | SDPA forward "
          f"{t_['library_ms']:.4f} ms (device {t_['library_device_ms']}) | "
          f"bound {t_['bound_ms']:.4f} ms ({t_['bound_by']}), "
          f"{t_['bound_ms'] / dev_t * 100:.2f} % of it, "
          f"{flops / dev_t / 1e9:.2f} TFLOP/s")
    return t_


def phase_scan_backward(torch) -> dict:
    phase("3f. rglru_scan_bwd and rwkv6_scan_bwd against their plain "
          "versions summed in float64")
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    f64 = torch.float64

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def hold(name, got, want, bar, what):
        """Each gradient within bar x max(1, max |oracle|); the worst
        absolute error."""
        worst, line = 0.0, []
        for gname, g, w_ in zip(("da", "db", "dh0") if len(got) == 3 else
                                ("dr", "dk", "dv", "dw", "du", "ds0"),
                                got, want):
            check((g is None) == (w_ is None), f"{name} {what} {gname}: "
                  f"{'missing' if g is None else 'not expected'}")
            if g is None:
                continue
            check(g.shape == w_.shape and g.dtype == torch.float32,
                  f"{name} {what} {gname}: {g.shape} {g.dtype}")
            scale = max(1.0, float(w_.abs().max()))
            e = err(g, w_)
            check(e <= bar * scale, f"{name} {what} {gname}: max|err| {e} > "
                  f"{bar:g} x {scale:.4g}")
            worst = max(worst, e)
            line.append(f"{gname} {e:.3e} (of {scale:.3g})")
        print(f"{name} {what}: max|err| " + ", ".join(line)
              + f"; bar {bar:g} x max(1, max|oracle|)")
        return worst

    def bit_equal(name, fn, what):
        one, two = fn(), fn()
        check(all((x is None and y is None) or bool(torch.equal(x, y))
                  for x, y in zip(one, two)), f"{name} {what}: two calls "
              "differ")
        return one

    out = {}
    # rglru: phase 18's shape, the forward row's, then S <= 32 (the
    # one-thread walk), ragged S across the 32-step chunks, h0 given, D % 4
    # != 0 (the 4-byte path of the wider loads)
    worst = 0.0
    for b, s, d, with_h0 in ((*RGLRU_BWD_MAIN, False), (6, 512, 2560, True),
                             (SERVE_BATCH, SERVE_PROMPT, 2560, True),
                             (SERVE_BATCH, 1, 2560, True), (3, 32, 100, False),
                             (2, 33, 2560, True), (3, 70, 300, True),
                             (2, 300, 100, False), (3, 70, 101, True)):
        a = torch.sigmoid(randn(b, s, d))
        h0 = randn(b, d) if with_h0 else None
        h = rg.rglru_scan(a, randn(b, s, d), h0)
        dh = randn(b, s, d)
        what = f"({b},{s},{d}) h0={with_h0}"
        got = bit_equal("rglru_scan_bwd", lambda: rg.rglru_scan_bwd(
            a, h, dh, h0), what)
        torch.cuda.synchronize()
        want = rg.rglru_scan_bwd_plain(a, h, dh, h0, acc_dtype=f64)
        worst = max(worst, hold("rglru_scan_bwd", got, want, TOL_RGLRU,
                                what))
        if (b, s, d) in (RGLRU_BWD_MAIN, (SERVE_BATCH, SERVE_PROMPT, 2560)):
            nbytes, flops = cost.rglru_bwd_cost(b, s, d, with_h0)
            b_ms, b_by = cost.bound(nbytes, flops)
            out[(b, s, d)] = {
                "ms": time_ms(torch, lambda: rg.rglru_scan_bwd(a, h, dh, h0),
                              reps=20),
                "plain_ms": time_ms(torch, lambda: rg.rglru_scan_bwd_plain(
                    a, h, dh, h0), reps=1, rounds=3, warmup=1),
                "library_ms": None,
                "device_ms": prof.device_ms(lambda: rg.rglru_scan_bwd(
                    a, h, dh, h0), ("rglru_bwd", "Memset"), calls=10),
                "bound_ms": b_ms, "bound_by": b_by,
                "shape": f"a, h, dh ({b},{s},{d}) fp32"
                         + (f", h0 ({b},{d})" if with_h0 else "")}
        del a, h, dh, got, want
    rglru = dict(out.pop(RGLRU_BWD_MAIN), max_abs_err=worst,
                 prefill=out.pop((SERVE_BATCH, SERVE_PROMPT, 2560)))

    # rwkv6: phase 19's shape (u per batch row, as the node axis folded into
    # B gives it), also in the served decay regime (w down to the 1e-12
    # floor), the forward row's shape, then ragged S (across the 16-step
    # chunks and the 64-step workspace groups), s0 and ds_final given, D 8,
    # 16, 32 and 128
    worst = 0.0
    cases = [(*RWKV_BWD_MAIN, False, True, "test"),
             (*RWKV_BWD_MAIN, True, True, "served"),
             (SERVE_BATCH, SERVE_PROMPT, 64, 64, True, False, "test"),
             (2, 37, 2, 64, False, False, "served"),
             (2, 100, 4, 64, True, False, "test"),
             (2, 45, 3, 32, True, True, "test"),
             (2, 33, 2, 128, True, False, "served"),
             (2, 40, 4, 16, False, True, "test"),
             (1, 17, 2, 8, True, True, "test"),
             (2, 63, 3, 64, True, True, "served"),
             (2, 65, 3, 64, True, True, "test"),
             (2, 129, 2, 64, True, True, "served")]
    for b, s, hh, d, states, u_rows, regime in cases:
        r, k, v = (randn(b, s, hh, d) for _ in range(3))
        if regime == "served":
            lw = -torch.exp(0.5 + 1.5 * torch.rand(
                (b, s, hh, d), generator=gen, device=dev) + randn(b, s, hh, d))
        else:
            lw = -torch.exp(randn(b, s, hh, d) * 0.5)
        w = torch.exp(lw)
        u = randn(b, hh, d) * 0.1 if u_rows else randn(hh, d) * 0.1
        s0 = randn(b, hh, d, d) if states else None
        dsf = randn(b, hh, d, d) if states else None
        dy = randn(b, s, hh, d)
        what = (f"({b},{s},{hh},{d}) states={states} u per row={u_rows} "
                f"{regime}")
        got = bit_equal("rwkv6_scan_bwd", lambda: rw.rwkv6_scan_bwd(
            r, k, v, w, u, dy, s0, dsf), what)
        torch.cuda.synchronize()
        want = rw.rwkv6_scan_bwd_plain(r, k, v, w, u, dy, s0, dsf,
                                       RWKV_CHUNK, acc_dtype=f64)
        worst = max(worst, hold("rwkv6_scan_bwd", got, want, TOL_RWKV, what))
        del got, want
        if (b, s, hh, d) in (RWKV_BWD_MAIN, (SERVE_BATCH, SERVE_PROMPT, 64,
                                             64)) and regime == "test":
            nbytes, flops = cost.rwkv_bwd_cost(b, s, hh, d, states, u_rows)
            b_ms, b_by = cost.bound(nbytes, flops)
            out[(b, s, hh, d)] = {
                "ms": time_ms(torch, lambda: rw.rwkv6_scan_bwd(
                    r, k, v, w, u, dy, s0, dsf), reps=3, rounds=3, warmup=1),
                "plain_ms": time_ms(torch, lambda: rw.rwkv6_scan_bwd_plain(
                    r, k, v, w, u, dy, s0, dsf, RWKV_CHUNK), reps=1,
                    rounds=3, warmup=1),
                "library_ms": None,
                "device_ms": prof.device_ms(lambda: rw.rwkv6_scan_bwd(
                    r, k, v, w, u, dy, s0, dsf), "rwkv6_bwd", calls=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "shape": f"r, k, v, w, dy ({b},{s},{hh},{d}) fp32, u "
                         + (f"({b},{hh},{d}) per row" if u_rows else
                            f"({hh},{d})")
                         + (f", s0, ds_final ({b},{hh},{d},{d})" if states
                            else "")}
        del r, k, v, w, u, s0, dsf, dy
    rwkv = dict(out.pop(RWKV_BWD_MAIN), max_abs_err=worst,
                prefill=out.pop((SERVE_BATCH, SERVE_PROMPT, 64, 64)))
    for name, t in (("rglru_scan_bwd", rglru),
                    ("rglru_scan_bwd", rglru["prefill"]),
                    ("rwkv6_scan_bwd", rwkv),
                    ("rwkv6_scan_bwd", rwkv["prefill"])):
        dms = "not measured" if t["device_ms"] is None \
            else f"{t['device_ms']:.4f} ms"
        dev_t = t["device_ms"] if t["device_ms"] is not None else t["ms"]
        print(f"{name:15s} {t['shape']}: {t['ms']:.4f} ms/call (device "
              f"{dms}) | plain {t['plain_ms']:.4f} ms | library none | bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / dev_t * 100:.1f} % of it "
              f"({'device' if t['device_ms'] is not None else 'per call'})")
    return {"rglru_scan_bwd": rglru, "rwkv6_scan_bwd": rwkv}


def train_counters() -> dict:
    """Every kernel a training round can launch, by name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "rglru_scan": rg.rglru_scan, "rglru_scan_bwd": rg.rglru_scan_bwd,
            "rwkv6_scan": rw.rwkv6_scan, "rwkv6_scan_bwd": rw.rwkv6_scan_bwd,
            "gossip_mix": gm.gossip_mix_rows}


def train_launches(mcfg, rounds: int, evals: int, mixes: int) -> dict:
    """The launches ``rounds`` training rounds and ``evals`` evaluations of
    ``mcfg`` make for all nodes at once (vmap folds the node axis into the
    batch): each kind's forward once a layer a round and an evaluation, its
    backward once a layer a round, ``mixes`` rows mixes a round."""
    from repro_torch.models import transformer

    kinds = transformer.layer_kinds(mcfg)
    per = {"flash_attention": sum(k in ("global", "local") for k in kinds),
           "rglru_scan": kinds.count("rglru"),
           "rwkv6_scan": kinds.count("rwkv")}
    want = {}
    for name, n in per.items():
        want[name] = (rounds + evals) * n
        want[f"{name}_bwd"] = rounds * n
    want["gossip_mix"] = rounds * mixes
    return want


def phase_train_lm(torch, label: str = "16", arch: str = TRAIN_ARCH,
                   layers: int = TRAIN_LAYERS, n_nodes: int | None = None,
                   batch: int = TRAIN_BATCH,
                   peak_gib: tuple = TRAIN_PEAK_GIB) -> dict:
    phase(f"{label}. train-on-trace of {arch} at full width on the card: "
          "D-PSGD over a precomputed wireless trace, every attention and "
          "scan forward and backward in the hand-written kernels")
    import dataclasses
    import gc
    import math

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.core import dpsgd
    from repro_torch.models import transformer
    from repro_torch.sim import batch as tb
    from repro_torch.sim import get_scenario, precompute_traces

    full = get_config(arch)
    mcfg = dataclasses.replace(full, n_layers=layers)
    ad = tb.transformer_adapter(mcfg, batch=batch, seq_len=TRAIN_SEQ,
                                eval_batch=TRAIN_EVAL_BATCH, device="cuda")
    n_params = int(ad.model_bits) // 32
    kw = {} if n_nodes is None else {"n_nodes": n_nodes}
    cfg = get_scenario("static", model_bits=ad.model_bits,
                       model_shapes=ad.param_shapes,
                       eval_every_rounds=TRAIN_ROUNDS, **kw)
    n = cfg.n_nodes
    replica = n_params * 4 / 1e9
    # the full-depth tree's parameters, counted without drawing one
    with FakeTensorMode():
        full_params = sum(x.numel() for x in dpsgd._leaves(
            transformer.init_params(full, torch.Generator(), "cpu")))
    embed = full.vocab_size * full.d_model * (1 if full.tie_embeddings
                                               else 2)
    print(f"{arch}: published widths (d_model {mcfg.d_model}, "
          f"{mcfg.n_heads} x {mcfg.head_dim} heads, d_ff {mcfg.d_ff}, vocab "
          f"{mcfg.vocab_size}, {'tied' if full.tie_embeddings else 'untied'}"
          f" head), depth cut {full.n_layers} -> {layers} "
          f"({', '.join(transformer.layer_kinds(mcfg))}): D-PSGD holds one "
          f"fp32 replica a node; {full_params / 1e9:.2f} B parameters at full "
          f"depth, {N_NODES} replicas "
          f"{N_NODES * 4 * full_params / 1e9:.1f} GB "
          f"before any gradient; at {layers} layer(s) {n_params:,} "
          f"parameters, {replica:.2f} GB ({replica * 1e9 / 2**30:.2f} GiB) a "
          f"replica, of which the embedding and head {embed * 4 / 1e9:.2f} "
          f"GB ({embed / n_params * 100:.1f} %), {n * replica:.2f} GB a "
          f"node-stacked copy. Parameters {mcfg.param_dtype}, compute "
          f"{mcfg.dtype}; {n} nodes x batch {batch} x {TRAIN_SEQ} tokens, "
          f"{TRAIN_ROUNDS} rounds of '{cfg.name}'")
    print(f"predicted peak memory {peak_gib[0]:g}-{peak_gib[1]:g} GiB "
          "(PERF.md, before the run)")
    traces = precompute_traces([cfg], TRAIN_ROUNDS)
    # the graph's capture (warm-up runs, cuBLAS plans, the kernels' first
    # launch) outside the measured run: one round, the same signature
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tb.train_model_on_traces(ad, [cfg], 1, trace_batch=precompute_traces(
        [cfg], 1), device="cuda")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"after the warm-up round: {torch.cuda.memory_allocated() / 2**30:.3f}"
          f" GiB allocated (the graph's pool and static inputs), "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    key = next(k for k in tb._STEPS if k[0] is ad.loss_fn)
    step = tb._STEPS[key]

    loop_s = []
    train_on_traces = tb.train_on_traces

    def timed(loss_fn, node_params, *args, **kwargs):
        # the initial parameters passed on with no reference kept here:
        # the round loop drops them once its graph holds them
        owned = [node_params]
        del node_params
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = train_on_traces(loss_fn, owned.pop(), *args, **kwargs)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t1)
        return res

    # the memory allocated as each round's step returns: past the second
    # round, a round may add only its node-0 snapshot (nothing of an
    # earlier round's outputs may stay alive)
    after_round = []
    family_step = tb._family_step

    measuring = tapped(family_step, lambda *_: after_round.append(
        torch.cuda.memory_allocated() / 2**30))

    counters = train_counters()
    torch.cuda.reset_peak_memory_stats()
    tb.train_on_traces = timed
    tb._family_step = measuring
    try:
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = tb.train_model_on_traces(ad, [cfg], TRAIN_ROUNDS,
                                          trace_batch=traces, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
    finally:
        tb.train_on_traces = train_on_traces
        tb._family_step = family_step
    peak = torch.cuda.max_memory_allocated() / 2**30
    snap = replica * 1e9 / 2**30
    growth = max(b - a for a, b in zip(after_round[1:], after_round[2:]))
    print(f"allocated as each round's step returns: "
          f"{[round(x, 3) for x in after_round]} GiB; past the second "
          f"round each adds at most {growth:.3f} GiB (its node-0 snapshot "
          f"is {snap:.3f} GiB)")
    check(len(after_round) == TRAIN_ROUNDS and growth <= snap + 1 / 16,
          f"{label}: rounds keep memory alive: {after_round} GiB")
    evals = len(out["eval_rounds"])
    # the mix's buffers: leaves concatenated up to MIX_CONCAT_LANES a node
    mixes = len(dpsgd.mix_groups([int(np.prod(s)) for s in ad.param_shapes]))
    want = train_launches(mcfg, TRAIN_ROUNDS, evals, mixes)
    print(f"launches {launches} (expected {want}: per round each attention "
          f"and scan layer's forward and backward kernel once for all {n} "
          f"nodes (vmap folds the node axis into the batch) and {mixes} rows "
          f"mixes (the leaves in buffers of at most "
          f"{dpsgd.MIX_CONCAT_LANES} lanes a node); the forwards also once "
          f"a layer in the {evals} evaluation)")
    check(launches == want, f"{label}: launches {launches}, want {want}")
    check(step.signatures == 1, f"{label}: {step.signatures} graph "
          "signatures")
    losses = out["losses"][0]
    acc = float(out["acc"][0, -1])
    print(f"masked mean losses {losses.tolist()} (ln V = "
          f"{math.log(mcfg.vocab_size):.4f}); accuracy {acc:.6f} at round "
          f"{out['eval_rounds'][-1] + 1}")
    check(np.isfinite(losses).all() and losses.shape == (TRAIN_ROUNDS,),
          f"{label}: losses {losses}")
    ln_v = math.log(mcfg.vocab_size)
    if mcfg.tie_embeddings:
        # a tied head at init scores each position's own token about
        # sqrt(d_model) above the others (the input embedding is scaled by
        # sqrt(d_model), the head reads the same table after the final
        # norm), in the JAX package as in the port: the first loss lies
        # between ln V and ln V + sqrt(d_model) (PERF.md)
        lo, hi = ln_v, ln_v + math.sqrt(mcfg.d_model)
    else:
        lo, hi = ln_v - 1.0, ln_v + 1.0
    why = "tied head: ln V to ln V + sqrt(d_model)" \
        if mcfg.tie_embeddings else "ln V within 1"
    print(f"the first loss against [{lo:.4f}, {hi:.4f}] ({why})")
    check(lo <= losses[0] <= hi, f"{label}: the first loss {losses[0]} is "
          f"outside [{lo}, {hi}]")
    check(0.0 <= acc <= 1.0, f"{label}: accuracy {acc}")
    finals = out["final_params"][0]
    check(all(bool(torch.isfinite(x).all()) for x in dpsgd._leaves(finals)),
          f"{label}: non-finite parameters")
    loop_ms = loop_s[0] * 1e3 / TRAIN_ROUNDS
    entry = next(iter(step._entries.values()))
    replay_ms = time_ms(torch, entry.graph.replay, reps=3, rounds=3,
                        warmup=1)
    idle = 1.0 - replay_ms / loop_ms
    top = prof.device_profile(entry.graph.replay, 1)
    busy = sum(r[1] for r in top)
    print(f"one replay under the profiler: {busy:.4f} ms of device "
          f"operations, the largest: " + "; ".join(
              f"{name[:48]} {ms:.3f} ms x{count}"
              for name, ms, count in top[:10]))
    print(f"the loop: {loop_ms:.4f} host ms per round (train_on_traces "
          f"{loop_s[0]:.4f} s for {TRAIN_ROUNDS} rounds), one replay of the "
          f"round {replay_ms:.4f} ms on the card (CUDA events), idle share "
          f"of the loop {idle:.4f}; train_model_on_traces {wall:.4f} s wall "
          f"(init, batches, evaluation included), warm-up and capture "
          f"{warm_s:.2f} s; peak memory {peak:.3f} GiB (predicted "
          f"{peak_gib[0]:g}-{peak_gib[1]:g})")

    # the family loop against the per-round reference (one graphed masked
    # step a round, host reads between), after the family's graph is freed
    fam_losses = losses.copy()
    # the family's final parameters wait on the host while the reference
    # runs; compared leaf by leaf on the card after it
    finals = dpsgd._tree_map(lambda x: x.cpu(), finals)
    del out, entry, step
    tb._STEPS.pop(key)
    gc.collect()
    torch.cuda.empty_cache()
    tr = traces.traces[0]
    p0 = dpsgd.replicate(ad.init_params(cfg.seed), n)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref_final, ref_losses = tb.train_on_trace_reference(
        ad.loss_fn, p0, tr.w_eff, tr.live, ad.batch_fn(cfg, tr),
        dpsgd.DPSGDConfig(eta=0.05), payload=cfg.payload,
        active_seq=tr.active)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_peak = torch.cuda.max_memory_allocated() / 2**30
    del p0
    ref_mean = np.where(tr.live, ref_losses, 0.0).sum(-1) / tr.live.sum(-1)
    d_loss = float(np.abs(ref_mean - fam_losses).max())
    d_par = max(float((a.to(b.device) - b).abs().max()) for a, b in zip(
        dpsgd._leaves(finals), dpsgd._leaves(ref_final)))
    print(f"the family loop against train_on_trace_reference (same card, "
          f"{TRAIN_ROUNDS} rounds free-running): max|mean loss diff| "
          f"{d_loss:.3e} (tol 1e-4), max|final parameter diff| {d_par:.3e} "
          f"(tol {TOL_FP32:g}); the reference {ref_s:.2f} s with its "
          f"capture, peak {ref_peak:.3f} GiB")
    check(d_loss <= 1e-4, f"{label}: family and reference losses differ by "
          f"{d_loss}")
    check(d_par <= TOL_FP32, f"{label}: family and reference parameters "
          f"differ by {d_par}")
    del finals, ref_final
    tb._STEPS.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": fam_losses.tolist(), "acc": acc,
            "loop_ms": loop_ms, "replay_ms": replay_ms, "idle": idle,
            "busy_ms": busy,
            "peak_gib": peak, "wall_s": wall, "d_loss": d_loss,
            "d_par": d_par}


def phase_train_lm_lockstep(torch, label: str = "17",
                            arch: str = TRAIN_ARCH) -> dict:
    phase(f"{label}. correctness of the training path: {arch}'s smoke "
          "config, card against CPU in lockstep")
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import dpsgd
    from repro_torch.core.compression import QuantConfig
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import quantize as qz
    from repro_torch.sim import batch as tb
    from repro_torch.sim import get_scenario

    ad = tb.transformer_adapter(arch, batch=TRAIN_BATCH,
                                seq_len=LOCK_TRAIN_SEQ, device="cuda")
    mcfg = reduce_for_smoke(get_config(arch))
    leaves = len(ad.param_shapes)
    counters = dict(train_counters(), quantize_int8_ef=qz.quantize_int8_ef,
                    gossip_mix_q8=gm.gossip_mix_q8_rows)
    to_cpu = lambda t: None if t is None else dpsgd._tree_map(  # noqa: E731
        lambda x: x.cpu(), t)
    rounds = LOCK_TRAIN_ROUNDS
    result = {}
    for name, payload in (("static", None),
                          ("compressed_int8",
                           QuantConfig(mode="int8", granularity="leaf"))):
        kw = {} if payload is None else {"payload": payload}
        cfg = get_scenario(name, model_bits=ad.model_bits,
                           model_shapes=ad.param_shapes,
                           eval_every_rounds=rounds, **kw)
        recorded = []
        family_step = tb._family_step

        recording = tapped(family_step, lambda *x: recorded.append(x),
                           keep_args=True)
        for c in counters.values():
            c.launches = 0
        tb._family_step = recording
        try:
            _, out = tb.train_model_on_traces(ad, [cfg], rounds,
                                              device="cuda")
            torch.cuda.synchronize()
        finally:
            tb._family_step = family_step
        launches = {k: c.launches for k, c in counters.items()}
        int8 = payload is not None
        mixes = len(dpsgd.mix_groups([int(np.prod(x))
                                      for x in ad.param_shapes]))
        want = dict(train_launches(mcfg, rounds, 1, 0 if int8 else mixes),
                    quantize_int8_ef=rounds * leaves if int8 else 0,
                    gossip_mix_q8=rounds * leaves if int8 else 0)
        check(launches == want, f"{label} {name}: launches {launches}, "
              f"want {want}")
        check(len(recorded) == rounds and np.isfinite(out["losses"]).all(),
              f"{label} {name}: {len(recorded)} rounds recorded, losses "
              f"{out['losses']}")
        worst = {"loss": 0.0, "params": 0.0, "residuals": 0.0}
        for step_r, args, o in recorded:
            cpu = step_r(*(to_cpu(a) for a in args))   # the CPU's eager body
            worst["loss"] = max(worst["loss"], err(o["losses"].cpu(),
                                                   cpu["losses"]))
            worst["params"] = max(worst["params"], max(
                err(a.cpu(), b) for a, b in zip(dpsgd._leaves(o["params"]),
                                                dpsgd._leaves(cpu["params"]))))
            if int8:
                worst["residuals"] = max(worst["residuals"], max(
                    err(a.cpu(), b) for a, b in zip(
                        dpsgd._leaves(o["res"]), dpsgd._leaves(cpu["res"]))))
        print(f"{label} {name}{' (per-leaf int8)' if int8 else ''}: {rounds} "
              f"rounds, launches "
              f"{ {k: v for k, v in launches.items() if v} }; losses "
              f"{out['losses'][0].tolist()}; card against CPU in lockstep: "
              f"max|loss diff| {worst['loss']:.3e} (tol 1e-4), max|param "
              f"diff| {worst['params']:.3e}, max|residual diff| "
              f"{worst['residuals']:.3e} (tol {TOL_FP32:g})")
        check(worst["loss"] <= 1e-4, f"{label} {name}: losses differ: "
              f"{worst}")
        check(worst["params"] <= TOL_FP32 and worst["residuals"] <= TOL_FP32,
              f"{label} {name}: parameters or residuals differ: {worst}")
        result[name] = {"launches": launches, **worst}
    tb._STEPS.clear()
    return result


# ---------------------------------------------------------------------------
# The scan trace engine
# ---------------------------------------------------------------------------

def run_trace(torch, fn, arrays, args, device, rounds: int,
              exact: bool = False) -> list:
    """``fn`` (the round loop's wrapper or its plain version) on ``arrays``
    moved to ``device``: its six outputs and its counts (passes run,
    decodes decided), on the host; with ``exact`` (the wrapper) also the
    decodes its kernel decided on the exact path."""
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    extra = {}
    if exact:
        extra["exact"] = torch.zeros(1, dtype=torch.int64, device=device)
    out = fn(*(torch.as_tensor(a, device=device) for a in arrays),
             n_rounds=rounds, counts=counts, **args, **extra)
    return [x.cpu() for x in out] + [counts.cpu()] + [
        x.cpu() for x in extra.values()]


def decode_margin(torch, arrays, args, r: int, i: int, j: int) -> float:
    """Smallest |cap - rate| / rate over receiver j's decodes of
    transmitter i's packets in round r, from the gains the plain version
    draws on the CPU (recorded as it draws them: every pass of every
    transmitter draws once)."""
    from repro_torch.kernels import trace_scan as ts

    drawn, gains = [], ts._rayleigh_gains

    def record(seed, blocks, tx, n):
        g = gains(seed, blocks, tx, n)
        if tx == i:
            drawn.append(g[:, j])
        return g
    ts._rayleigh_gains = record
    try:
        run_trace(torch, ts.round_scan_plain, arrays, args,
                  torch.device("cpu"), r + 1)
    finally:
        ts._rayleigh_gains = gains
    passes = args["passes"]
    g = torch.cat(drawn[r * passes:(r + 1) * passes])
    rate, bw = float(arrays[0][i]), args["bandwidth_hz"]
    cap = bw * torch.log2(1.0 + float(arrays[3][i, j]) * g / bw)
    return float(((cap - rate).abs() / rate).min())


def hold_trace(torch, what: str, arrays, args, got: list, want: list,
               against: str, worst: dict) -> None:
    """The round loop's outputs against ``want``'s: delivered, retx, w_eff
    and the counts equal, times within TOL_TIME relative. Any decode that
    differs is printed with its margin and fails the phase."""
    bad = (got[3] != want[3]).nonzero().tolist()
    for r, i, j in bad[:10]:
        margin = (decode_margin(torch, arrays, args, r, i, j)
                  if args["fading_on"] else "none (static decode table)")
        print(f"   decode differs: round {r}, transmitter {i}, receiver "
              f"{j}: kernel {bool(got[3][r, i, j])}, {against} "
              f"{bool(want[3][r, i, j])}; min |cap - rate| / rate {margin}")
    t_rel = t_abs = 0.0
    for k in (1, 2, 5):                     # t_start, t_comm, t_end
        d = (got[k] - want[k]).abs()
        t_abs = max(t_abs, float(d.max()) if d.numel() else 0.0)
        if d.numel():
            t_rel = max(t_rel, float((d / want[k].abs().clamp_min(
                1e-300)).max()))
    same = {"retx": torch.equal(got[4], want[4]),
            "w_eff": torch.equal(got[0], want[0]),
            "counts": torch.equal(got[6], want[6])}
    print(f"{what} against {against}: delivered "
          f"{'equal' if not bad else f'{len(bad)} DIFFER'}, "
          + ", ".join(f"{k} {'equal' if v else 'DIFFER'}"
                      for k, v in same.items())
          + f", times max rel {t_rel:.3e} (abs {t_abs:.3e} s; tol "
          f"{TOL_TIME:g}); {int(got[6][0])} passes, {int(got[6][1])} "
          f"decodes"
          + (f" ({int(got[7][0])} on the exact path)" if len(got) > 7
             else "") + f", retx {got[4].tolist()}")
    check(not bad and all(same.values()) and t_rel <= TOL_TIME,
          f"{what} against {against}: {len(bad)} decodes differ, {same}, "
          f"times {t_rel}")
    worst["t_rel"] = max(worst["t_rel"], t_rel)
    worst["t_abs"] = max(worst["t_abs"], t_abs)


def hold_long_traces(torch, worst: dict) -> dict:
    """Phase 21 (a): TRAIN_ARCH cut to TRAIN_LAYERS layers (phase 16's
    model; ``model_bits`` from ``transformer_adapter``, ~329 000 packets),
    through ``precompute_trace(engine="scan", device="cuda")`` on each of
    TRACE_LONG_SCENARIOS (``static`` is phase 16's scenario): one launch,
    its outputs captured at the wrapper and held against the plain
    version on the card and on the CPU with (a)'s bars, the trace's w_eff
    equal to the captured one. Returns, per scenario, the call's ms (CUDA
    events), passes, µs a pass (the serial running sum over the packets),
    decodes and exact-path decodes."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import trace_scan as ts
    from repro_torch.sim import (WirelessSimulator, batch as tb,
                                 get_scenario, jit_trace, precompute_trace)

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    mcfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    ad = tb.transformer_adapter(mcfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                eval_batch=TRAIN_EVAL_BATCH, device="cuda")
    round_scan, out = jit_trace.round_scan, {}
    for name in TRACE_LONG_SCENARIOS:
        kw = ({"eval_every_rounds": TRAIN_ROUNDS} if name == "static"
              else NO_SHADOW)
        cfg = get_scenario(name, model_bits=ad.model_bits,
                           model_shapes=ad.param_shapes, **kw)
        seen = {}

        def captured(*a, **k):
            counts = torch.zeros(2, dtype=torch.int64, device=dev)
            exact = torch.zeros(1, dtype=torch.int64, device=dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = round_scan(*a, counts=counts, exact=exact, **k)
            end.record()
            end.synchronize()
            seen.update(ms=start.elapsed_time(end), out=[
                x.cpu() for x in res] + [counts.cpu(), exact.cpu()])
            return res
        before = ts.round_scan.launches
        jit_trace.round_scan = captured
        try:
            tr = precompute_trace(cfg, TRACE_HELD_ROUNDS, engine="scan",
                                  device="cuda")
        finally:
            jit_trace.round_scan = round_scan
        launches = ts.round_scan.launches - before
        arrays, args = jit_trace.scan_inputs(cfg, WirelessSimulator(cfg))
        what = (f"(a) {TRAIN_ARCH} {TRAIN_LAYERS} layer, {name} "
                f"n={cfg.n_nodes} P={args['n_pkts']} "
                f"passes={args['passes']}, precompute_trace(engine='scan')")
        check(launches == 1, f"{what}: {launches} launches, want 1")
        got = seen["out"]
        check(np.array_equal(tr.w_eff, got[0].numpy()),
              f"{what}: the trace's w_eff is not the kernel's")
        for against, device in (("the plain version on the card", dev),
                                ("the plain version on the CPU", cpu)):
            want = run_trace(torch, ts.round_scan_plain, arrays, args,
                             device, TRACE_HELD_ROUNDS)
            hold_trace(torch, what, arrays, args, got, want, against, worst)
        passes, decodes = int(got[6][0]), int(got[6][1])
        out[name] = {"ms": seen["ms"], "passes": passes,
                     "us_per_pass": seen["ms"] * 1e3 / passes,
                     "decodes": decodes, "exact": int(got[7][0]),
                     "n_pkts": args["n_pkts"]}
        print(f"{what}: the round loop's call {seen['ms']:.4f} ms (CUDA "
              f"events), {passes} passes, {out[name]['us_per_pass']:.2f} us "
              f"a pass (the running sum over {args['n_pkts']} packets on one "
              f"thread), {decodes} decodes, {out[name]['exact']} on the "
              f"exact path")
    return out


def check_decide(torch) -> dict:
    """Phase 21 (a): the round loop's decision through ``trace_decide`` at
    every intended pair of ``fading`` at TRACE_DECIDE_N nodes, m at the
    card's m_lo - 1, m_lo, the middle of the band, m_hi, m_hi + 1 and 64
    uniform draws: the filtered decision equal to the kernel's exact
    code, the band's edges where the path changes, the exact code equal
    to the plain version's on the CPU outside the band, the thresholds
    the plain version's to one grid step."""
    from repro_torch.kernels import trace_scan as ts
    from repro_torch.sim import WirelessSimulator, get_scenario, jit_trace

    dev = torch.device("cuda")
    total = {"decisions": 0, "banded": 0, "launches": 0}
    for n in TRACE_DECIDE_N:
        cfg = get_scenario("fading", n_nodes=n, **NO_SHADOW)
        (rates, _, recv, chan, _), args = jit_trace.scan_inputs(
            cfg, WirelessSimulator(cfg))
        i, j = np.nonzero(recv)
        snr, rate = torch.as_tensor(chan[i, j]), torch.as_tensor(rates[i])
        bw, k = args["bandwidth_hz"], len(i)
        before = ts.trace_decide.launches
        thr = ts.trace_decide(snr.to(dev), rate.to(dev), torch.zeros(
            k, dtype=torch.int64, device=dev), bandwidth_hz=bw)[0].cpu()
        lo, hi = thr[:, 0], thr[:, 1]
        gen = torch.Generator().manual_seed(n)
        m = torch.stack([lo - 1, lo, (lo + hi) // 2, hi, hi + 1,
                         *torch.randint(0, 2**53, (64, k), generator=gen)]
                        ).clamp(0, 2**53 - 1)
        reps = m.shape[0]
        thr2, filtered, exact, banded = (x.cpu() for x in ts.trace_decide(
            snr.repeat(reps).to(dev), rate.repeat(reps).to(dev),
            m.ravel().to(dev), bandwidth_hz=bw))
        total["launches"] += ts.trace_decide.launches - before
        plain_thr = ts.fade_thresholds_plain(snr, rate, bw)
        cpu_exact = ts._exact_decode(m.ravel(), snr.repeat(reps),
                                     rate.repeat(reps), bw)
        b = banded.view(reps, k)
        thr_gap = int((thr - plain_thr).abs().max())
        same = {"filtered == exact": torch.equal(filtered, exact),
                "edges": bool(not b[[0, 4]].any() and b[[1, 2, 3]].all()),
                "exact == CPU outside the band": torch.equal(
                    exact[~banded], cpu_exact[~banded]),
                "thresholds": torch.equal(thr2, thr.repeat(reps, 1))
                and thr_gap <= 1}
        print(f"(a) trace_decide, fading n={n}: {k} pairs x {reps} m, "
              f"{int(banded.sum())} in the band; "
              + ", ".join(f"{key} {'yes' if v else 'NO'}"
                          for key, v in same.items())
              + f" (thresholds within {thr_gap} of the CPU's)")
        check(all(same.values()), f"(a) trace_decide at n={n}: {same}")
        total["decisions"] += int(banded.numel())
        total["banded"] += int(banded.sum())
    return total


def phase_trace_scan(torch) -> dict:
    phase("21. the scan trace engine: its round loop in one CUDA kernel, "
          f"--scale at n = {TRACE_N}, train-on-trace through it")
    from repro_torch.core import dpsgd
    from repro_torch.core.topology import spectral_lambda
    from repro_torch.data import SyntheticFashion
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import trace_scan as ts
    from repro_torch.sim import (WirelessSimulator, batch as tb,
                                 get_scenario, jit_trace, train_cnn_on_traces)

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    worst = {"t_rel": 0.0, "t_abs": 0.0}

    # (a) the kernel against its plain version on the card and on the CPU;
    # the plain loop runs once a case on each device, and each degrade
    # mode's w_eff is assembled from its delivered as the plain version
    # assembles it (the loop never reads the mode)
    t0 = time.perf_counter()
    for name, n, kw, degrades in TRACE_CASES:
        cfg = get_scenario(name, n_nodes=n,
                           **({} if name == "static" else NO_SHADOW), **kw)
        arrays, args = jit_trace.scan_inputs(cfg, WirelessSimulator(cfg))
        plain = {device: run_trace(torch, ts.round_scan_plain, arrays,
                                   {**args, "degrade": degrades[0]}, device,
                                   TRACE_HELD_ROUNDS) for device in (dev, cpu)}
        for degrade in degrades:
            a = {**args, "degrade": degrade}
            what = (f"(a) {name} n={n} P={a['n_pkts']} passes={a['passes']} "
                    f"{degrade}")
            before = ts.round_scan.launches
            got = run_trace(torch, ts.round_scan, arrays, a, dev,
                            TRACE_HELD_ROUNDS, exact=True)
            check(ts.round_scan.launches == before + 1,
                  f"{what}: {ts.round_scan.launches - before} launches")
            for against, device in (("the plain version on the card", dev),
                                    ("the plain version on the CPU", cpu)):
                want = list(plain[device])
                want[0] = ts.assemble_w(want[3], torch.as_tensor(arrays[4]),
                                        degrade)
                hold_trace(torch, what, arrays, a, got, want, against, worst)
    long_traces = hold_long_traces(torch, worst)
    decide = check_decide(torch)
    print(f"(a) {time.perf_counter() - t0:.2f} s")

    # (b) --scale's configuration at n = TRACE_N: the certified plan on the
    # host once, then precompute_trace_scan through the kernel
    cfg = get_scenario("fading", n_nodes=TRACE_N, **NO_SHADOW)
    t0 = time.perf_counter()
    sim = WirelessSimulator(cfg)
    plan_s = time.perf_counter() - t0
    sol = sim.solution
    certified = sol.lam == spectral_lambda(sol.w)
    check(certified and sol.feasible,
          f"(b) the n = {TRACE_N} plan: certified {certified}, feasible "
          f"{sol.feasible}")
    arrays, args = jit_trace.scan_inputs(cfg, sim)
    seen = {}
    round_scan = jit_trace.round_scan

    def timed(*a, **k):
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        exact = torch.zeros(1, dtype=torch.int64, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        start.record()
        out = round_scan(*a, counts=counts, exact=exact, **k)
        end.record()
        end.synchronize()
        seen.update(call_ms=start.elapsed_time(end),
                    host_s=time.perf_counter() - h0, out=out,
                    counts=counts.cpu(), exact=int(exact.cpu()[0]),
                    back=time.perf_counter())
        return out
    for c in (ts.round_scan, gm.gossip_mix_rows):
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    jit_trace.round_scan = timed
    try:
        t0 = time.perf_counter()
        tr = jit_trace.precompute_trace_scan(cfg, TRACE_ROUNDS, sim=sim,
                                             device="cuda")
        t_end = time.perf_counter()
    finally:
        jit_trace.round_scan = round_scan
    launches_b = ts.round_scan.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    trace_s = t_end - t0
    t1 = time.perf_counter()
    for x in seen["out"]:
        x.cpu()
    copy_s = time.perf_counter() - t1
    epilogue_s = t_end - seen["back"] - copy_s
    setup_s = trace_s - seen["host_s"] - (t_end - seen["back"])
    s = tr.trace.summary()
    print(f"(b) # n={TRACE_N}: plan {plan_s:.2f}s (lambda {sol.lam:.4f} <= "
          f"{cfg.lambda_target} target, feasible={sol.feasible}, "
          f"certified={certified}), {TRACE_ROUNDS} rounds in {trace_s:.2f}s "
          f"({TRACE_ROUNDS / trace_s:.2f} rounds/s), outage "
          f"{s['outage_rate']:.1%}, comm {s['total_comm_s']:.1f}s sim")
    check(launches_b == 1, f"(b) {launches_b} launches of the round loop, "
          "want 1")
    w = tr.w_eff
    check(w.shape == (TRACE_ROUNDS, TRACE_N, TRACE_N)
          and np.isfinite(w).all() and np.allclose(w.sum(-1), 1.0)
          and (np.diff(tr.t_start_s) > 0).all() and s["retx_packets"] > 0,
          f"(b) trace: w_eff {w.shape}, finite {np.isfinite(w).all()}, "
          f"retx {s['retx_packets']}")
    passes_run, decodes = (int(x) for x in seen["counts"])
    b_ms, b_by = cost.bound(*cost.trace_cost(
        TRACE_N, args["n_pkts"], TRACE_ROUNDS, True, decodes),
        peak=cost.FP64_FLOPS)
    dev_arrays = [torch.as_tensor(a, device=dev) for a in arrays]
    ops = prof.device_profile(lambda: ts.round_scan(
        *dev_arrays, n_rounds=TRACE_ROUNDS, **args), 1)
    kernel_ms = sum(r[1] for r in ops if "trace_scan_kernel" in r[0]) or None
    print(f"(b) the round loop's call {seen['call_ms']:.4f} ms (CUDA events;"
          f" the kernel alone {kernel_ms} ms on the device, profiler), "
          f"{passes_run} transmitter passes ({seen['call_ms'] * 1e3 / passes_run:.4f}"
          f" us each: the chain), {decodes} decodes ({seen['exact']} on the "
          f"exact path); bound {b_ms:.4f} ms "
          f"({b_by}); set-up {setup_s:.4f} s, copy-out {copy_s:.4f} s, host "
          f"epilogue (lambda estimate, records) {epilogue_s:.4f} s; peak "
          f"memory {peak:.3f} GiB")
    # the first rounds held against the plain version on the card
    t1 = time.perf_counter()
    first = run_trace(torch, ts.round_scan, arrays, args, dev,
                      TRACE_HELD_ROUNDS, exact=True)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    plain = run_trace(torch, ts.round_scan_plain, arrays, args, dev,
                      TRACE_HELD_ROUNDS)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    hold_trace(torch, f"(b) n={TRACE_N}, first {TRACE_HELD_ROUNDS} rounds",
               arrays, args, first, plain, "the plain version on the card",
               worst)
    full = seen["out"]
    check(torch.equal(full[3][:TRACE_HELD_ROUNDS].cpu(), first[3])
          and torch.equal(full[1][:TRACE_HELD_ROUNDS].cpu(), first[1]),
          "(b) the 30-round trace's first rounds differ from a 2-round run")
    print(f"(b) {TRACE_HELD_ROUNDS} rounds: kernel {first_ms:.2f} ms, plain "
          f"version on the card {plain_ms:.2f} ms (host clock, synchronised)")

    # (c) train-on-trace at n = TRACE_TRAIN_N through the scan engine
    cfgs = [get_scenario("fading", n_nodes=TRACE_TRAIN_N, seed=s, **NO_SHADOW)
            for s in range(TRACE_SEEDS)]
    ds = SyntheticFashion(n_train=TRACE_TRAIN_N * TRACE_PER_NODE,
                          n_test=1000, seed=0)
    rounds = TRACE_PER_NODE // 25
    recorded, shapes = [], []
    family_step, mix = tb._family_step, dpsgd.gossip_mix_rows

    def record(step, args_, out):
        recorded.append((step, args_, out))

    def mix_seen(w_, bufs):
        shapes.append((tuple(w_.shape), tuple(bufs.shape)))
        return mix(w_, bufs)
    counters = {"trace_scan": ts.round_scan,
                "gossip_mix": gm.gossip_mix_rows,
                "gossip_mix_q8": gm.gossip_mix_q8_rows,
                "quantize_int8_ef": qz.quantize_int8_ef}
    for c in counters.values():
        c.launches = 0
    tb._family_step = tapped(family_step, record, keep_args=True)
    dpsgd.gossip_mix_rows = mix_seen
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        traces, out = train_cnn_on_traces(cfgs, epochs=1, ds=ds, n_test=1000,
                                          engine="scan", device="cuda")
        torch.cuda.synchronize()
    finally:
        tb._family_step, dpsgd.gossip_mix_rows = family_step, mix
    train_s = time.perf_counter() - t0
    launches_c = {k: c.launches for k, c in counters.items()}
    want = {"trace_scan": TRACE_SEEDS, "gossip_mix": TRACE_SEEDS * rounds,
            "gossip_mix_q8": 0, "quantize_int8_ef": 0}
    n = TRACE_TRAIN_N
    print(f"(c) fading x {TRACE_SEEDS} seeds at n={n}, {rounds} rounds "
          f"through the scan engine in {train_s:.2f} s: launches "
          f"{launches_c} (expected {want}); rows mix W and buffers "
          f"{sorted(set(shapes))}; losses {out['losses'].round(4).tolist()}, "
          f"accuracy {out['acc'][:, -1].round(4).tolist()}")
    check(launches_c == want, f"(c) launches {launches_c}, want {want}")
    check(shapes and all(w_ == (n, n) for w_, _ in shapes),
          f"(c) the rows mix ran at {set(shapes)}, not W ({n} x {n})")
    check(np.isfinite(out["losses"]).all() and traces.w_eff.shape
          == (TRACE_SEEDS, rounds, n, n), f"(c) losses {out['losses']}")
    to_cpu = lambda t: None if t is None else dpsgd._tree_map(  # noqa: E731
        lambda x: x.cpu(), t)
    lock = {"loss": 0.0, "params": 0.0}
    for step_r, args_, out_r in recorded:
        ref = step_r(*(to_cpu(a) for a in args_))   # CPU: the eager body
        lock["loss"] = max(lock["loss"], err(out_r["losses"].cpu(),
                                             ref["losses"]))
        lock["params"] = max(lock["params"], max(
            err(a.cpu(), b) for a, b in zip(dpsgd._leaves(out_r["params"]),
                                            dpsgd._leaves(ref["params"]))))
    print(f"(c) its {len(recorded)} family rounds card vs CPU in lockstep: "
          f"max|loss diff| {lock['loss']:.3e} (tol 1e-4), max|param diff| "
          f"{lock['params']:.3e} (tol {TOL_FP32:g})")
    check(len(recorded) == rounds, f"(c) recorded {len(recorded)} rounds")
    check(lock["loss"] <= 1e-4 and lock["params"] <= TOL_FP32,
          f"(c) card and CPU differ: {lock}")

    # row 1 at W (n x n): the rows mix against torch.matmul at this shape
    gen = torch.Generator(device="cpu").manual_seed(21)
    w_ = torch.softmax(torch.randn((n, n), generator=gen), -1).to(dev)
    bufs = torch.randn((n, 21_840), generator=gen).to(dev)
    e = err(gm.gossip_mix_rows(w_, bufs), gm.gossip_mix_rows_plain(w_, bufs))
    check(e <= TOL_FP32, f"rows mix at W ({n} x {n}): max|err| {e}")
    r_ms, r_by = cost.bound(*cost.rows_cost(n, n, 21_840, 4))
    eager_ms, library_ms = paired_ms(torch, lambda: gm.gossip_mix_rows(w_, bufs),
                                     lambda: torch.matmul(w_, bufs))
    w256 = {"ms": eager_ms, "library_ms": library_ms,
            "plain_ms": time_ms(torch, lambda: gm.gossip_mix_rows_plain(
                w_, bufs), reps=3, rounds=3, warmup=1),
            "graph_ms": graph_ms(torch, lambda: gm.gossip_mix_rows(w_, bufs)),
            "library_graph_ms": graph_ms(torch,
                                         lambda: torch.matmul(w_, bufs)),
            "device_ms": prof.device_ms(lambda: gm.gossip_mix_rows(
                w_, bufs), "gossip_mix_rows"),
            "bound_ms": r_ms, "bound_by": r_by, "max_abs_err": e,
            "shape": f"W ({n}x{n}) fp32, bufs ({n}x21840) fp32"}
    print_times("gossip_mix", w256)
    against_library("gossip_mix", w256, "torch.matmul")

    return {"trace_scan": {
        "max_abs_err": worst["t_abs"], "max_rel_err": worst["t_rel"],
        "ms": seen["call_ms"], "device_ms": kernel_ms,
        "plain_ms": plain_ms, "plain_rounds": TRACE_HELD_ROUNDS,
        "ms_held_rounds": first_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "graph_ms": None, "library_graph_ms": None,
        "passes": passes_run, "decodes": decodes,
        "exact_decodes": seen["exact"], "long_traces": long_traces,
        "decide_check": decide,
        "shape": f"fading n={TRACE_N}, P={args['n_pkts']}, passes "
                 f"{args['passes']}, {TRACE_ROUNDS} rounds"},
        "launches": {"(b) --scale": launches_b,
                     "(c) train-on-trace": launches_c["trace_scan"]},
        "launches_c_mix": launches_c["gossip_mix"],
        "w256": w256,
        "scale": {"plan_s": plan_s, "trace_s": trace_s, "setup_s": setup_s,
                  "copy_s": copy_s, "epilogue_s": epilogue_s,
                  "rounds_per_s": TRACE_ROUNDS / trace_s, "peak_gib": peak}}


def pod_counters() -> dict:
    """The kernels a pod-mode step of qwen2-vl-2b launches, by name."""
    return {k: c for k, c in train_counters().items()
            if k in ("flash_attention", "flash_attention_bwd", "gossip_mix")}


def pod_batch(torch, cfg, k: int, nodes: int, batch: int, seq: int,
              mode: str) -> dict:
    """Step ``k``'s batch as ``launch.train`` makes it."""
    from repro_torch.launch import train as lt
    from repro_torch.train import step as ts

    b = lt._batch(cfg, _pod_run(mode), k, nodes * batch, seq,
                  torch.device("cuda"))
    return ts.reshape_batch_for_nodes(b, nodes) if mode == "dpsgd" else b


def _pod_run(mode: str, optimizer: str = "adamw", eta: float = 1e-3,
             compression: str = "none", microbatch: int = 0):
    from repro_torch.configs import RunConfig

    return RunConfig(mode=mode, optimizer=optimizer, eta=eta,
                     compression=compression, microbatch=microbatch,
                     lambda_target=0.8, remat="none")


def pod_first_loss(cfg, loss: float, what: str) -> None:
    """The first loss near ln V: for a tied head between ln V and ln V +
    sqrt(d_model) (phase 16's rule), else within 1 of ln V."""
    import math

    ln_v = math.log(cfg.vocab_size)
    lo, hi = (ln_v, ln_v + math.sqrt(cfg.d_model)) if cfg.tie_embeddings \
        else (ln_v - 1.0, ln_v + 1.0)
    print(f"{what}: the first loss {loss:.4f} against [{lo:.4f}, {hi:.4f}] "
          f"(ln V = {ln_v:.4f})")
    check(lo <= loss <= hi, f"{what}: the first loss {loss} is outside "
          f"[{lo}, {hi}]")


def pod_profile(torch, step_fn, state, batch, host_ms: float,
                what: str) -> dict:
    """One eager step: CUDA events around it, the profiler's busy time and
    largest device operations, the idle share against ``host_ms``."""
    import gc

    out = step_fn(state, batch)          # warm (cuBLAS plans)
    del out
    gc.collect()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = step_fn(state, batch)
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end)
    del out
    gc.collect()
    traced = prof.trace(lambda: step_fn(state, batch))
    top, busy = traced["top"], traced["busy_ms"]
    idle = 1.0 - busy / host_ms if host_ms else None
    print(f"{what}: one eager step {event_ms:.2f} ms between CUDA events, "
          f"{busy:.2f} ms of device operations (profiler), idle share "
          f"{idle:.4f} of the loop's {host_ms:.2f} host ms a step; the "
          f"largest: " + "; ".join(f"{n[:44]} {ms:.3f} ms x{c}"
                                   for n, ms, c in top[:10]))
    return {"event_ms": event_ms, "busy_ms": busy, "idle": idle,
            "top": [(n[:80], ms, c) for n, ms, c in top[:10]],
            "traced_launches": traced["launches"],
            "gaps": [(ms, a[:60], b[:60]) for ms, a, b in traced["gaps"]]}


def pod_loop(torch, cfg, run, nodes: int, layers_note: str, what: str,
             peak: tuple) -> dict:
    """``launch.train.train_loop`` at POD_NODES x POD_BATCH x POD_SEQ for
    POD_WARM + POD_TIMED steps, eager, a loss logged each step: ms a step
    and tokens/s over the timed steps, launches, peak memory."""
    import math

    from repro_torch.launch import train as lt

    counters = pod_counters()
    steps = POD_WARM + POD_TIMED
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    out = lt.train_loop(cfg, run, nodes=nodes, tp=1, steps=steps,
                        batch_per_node=POD_BATCH, seq_len=POD_SEQ,
                        ckpt_dir=None, log_every=1, device="cuda",
                        graphed=False)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in out["log"]]
    walls = [r["wall_s"] for r in out["log"]]
    ms = (walls[-1] - walls[POD_WARM - 1]) * 1e3 / POD_TIMED
    tokens = nodes * POD_BATCH * POD_SEQ
    print(f"{what} ({layers_note}): {steps} steps, losses {losses}; "
          f"{ms:.2f} ms a step over the last {POD_TIMED} (host clock, a loss "
          f"read each step), {tokens / ms * 1e3:.0f} tokens/s; launches "
          f"{launches}; peak {peak_gib:.3f} GiB (predicted {peak[0]:g}-"
          f"{peak[1]:g})")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{what}: losses {losses}")
    pod_first_loss(cfg, losses[0], what)
    return {"losses": losses, "ms": ms, "tokens_per_s": tokens / ms * 1e3,
            "launches": launches, "peak_gib": peak_gib, "steps": steps}


def pod_lockstep(torch, name: str, run, cfg) -> dict:
    """POD_LOCK_STEPS steps of ``make_train_step`` at the smoke widths, a
    CUDA graph on the card, each rerun eagerly on the CPU from the card's
    state: losses 1e-4, parameters and residuals 1e-5, the optimizer's
    leaves 1e-5 of their leaf's max |x|; AdamW's entries whose two steps
    (each from its own moments) differ by more than 5e-6 held within 1e-5
    of that difference."""
    from repro_torch.core import dpsgd
    from repro_torch.core.gossip import ring_plan
    from repro_torch.graphs import GraphedStep
    from repro_torch.models import build
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import step as ts

    plan = ring_plan(("data",), (POD_NODES,), 1) \
        if run.mode == "dpsgd" else None
    card = GraphedStep(ts.make_train_step(build(cfg, "cuda"), run, plan,
                                          constant_lr(run.eta)))
    host = ts.make_train_step(build(cfg, "cpu"), run, plan,
                              constant_lr(run.eta))
    state = ts.init_train_state(
        build(cfg, "cuda"), run,
        torch.Generator(device="cuda").manual_seed(1), n_nodes=POD_NODES)
    # held at the lockstep bars each step (hold_step)
    adamw = run.optimizer == "adamw"
    d_loss, held, losses = 0.0, None, []
    for k in range(POD_LOCK_STEPS):
        batch = pod_batch(torch, cfg, k, POD_NODES, POD_LOCK_BATCH,
                          POD_LOCK_SEQ, run.mode)
        prev = tree_to(state, "cpu")
        cpu_out, cpu_m = host(prev, tree_to(batch, "cpu"))
        state, m = card(state, batch)
        losses.append(float(m["loss"]))
        d_loss = max(d_loss, err(m["loss"].cpu(), cpu_m["loss"]))
        check(sorted(state) == sorted(cpu_out), f"22 (c) {name}: state keys")
        check(int(state["step"]) == int(cpu_out["step"]) == k + 1,
              f"22 (c) {name}: step counters")
        held = hold_step(torch, f"step {k + 1}", state, cpu_out, prev,
                         run.eta, adamw, held)
    print(f"22 (c) {name}: {POD_LOCK_STEPS} steps, losses {losses}; card "
          f"(a CUDA graph, {card.signatures} signature) against CPU in "
          f"lockstep: max|loss diff| {d_loss:.3e} (tol {LOCK_TOL:g})")
    check(d_loss <= LOCK_TOL, f"22 (c) {name}: losses differ by {d_loss}")
    report_held(f"22 (c) {name}, card against CPU", held, adamw)
    if run.compression != "none":
        check(any(bool(x.any()) for x in dpsgd._leaves(state["residual"])),
              f"22 (c) {name}: the residual stayed zero")
    return {"loss": d_loss, **held}


def phase_pod_training(torch) -> dict:
    phase("22. pod-mode training of qwen2-vl-2b on the card: the Mode A / "
          "Mode B steps, their optimizers, checkpoints and the trainer "
          "(launch.train)")
    import dataclasses
    import gc
    import math
    import tempfile

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.checkpoint import save
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import dpsgd
    from repro_torch.core.density_controller import choose_plan
    from repro_torch.core.gossip import plan_w, ring_plan
    from repro_torch.graphs import GraphedStep
    from repro_torch.launch import train as lt
    from repro_torch.models import build, transformer
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import step as ts

    full = get_config(POD_ARCH)
    with FakeTensorMode():
        sizes = [x.numel() for x in dpsgd._leaves(transformer.init_params(
            full, torch.Generator(), "cpu"))]
    per_layer = (sum(sizes) - full.vocab_size * full.d_model
                 - full.d_model) / full.n_layers
    print(f"{POD_ARCH}: published widths (d_model {full.d_model}, "
          f"{full.n_heads} q heads on {full.n_kv_heads} kv heads of "
          f"{full.head_dim}, d_ff {full.d_ff}, vocab {full.vocab_size}, QKV "
          f"bias, tied embeddings, a vision stub of {full.n_patches} patch "
          f"positions); {sum(sizes) / 1e9:.4f} B parameters a replica, the "
          f"embedding {full.vocab_size * full.d_model / 1e6:.1f} M, "
          f"{per_layer / 1e6:.2f} M a layer; {POD_NODES} nodes x batch "
          f"{POD_BATCH} x {POD_SEQ} tokens a step; parameters "
          f"{full.param_dtype}, compute {full.dtype}")
    result: dict = {"launches": {}}

    # (a) Mode A at full width and depth through the trainer
    run_a = _pod_run("allreduce", microbatch=POD_A_MICROBATCH)
    a = pod_loop(torch, full, run_a, POD_NODES,
                 f"{full.n_layers} layers, {POD_A_MICROBATCH} microbatches",
                 "22 (a) Mode A (allreduce)", POD_PEAK_GIB["a"])
    calls = full.n_layers * POD_A_MICROBATCH * a["steps"]
    want = {"flash_attention": calls, "flash_attention_bwd": calls,
            "gossip_mix": 0}
    check(a["launches"] == want, f"22 (a): launches {a['launches']}, want "
          f"{want} (one flash forward and backward a layer a microbatch; "
          f"Mode A mixes nothing)")
    gc.collect()
    torch.cuda.empty_cache()
    api = build(full, "cuda")
    state = ts.init_train_state(api, run_a, torch.Generator(
        device="cuda").manual_seed(0), n_nodes=POD_NODES)
    a["profile"] = pod_profile(
        torch, ts.make_train_step(api, run_a, None, constant_lr(run_a.eta)),
        state, pod_batch(torch, full, 0, POD_NODES, POD_BATCH, POD_SEQ,
                         "allreduce"), a["ms"], "22 (a)")
    del state, api
    gc.collect()
    torch.cuda.empty_cache()
    result["a"] = a
    result["launches"]["(a) Mode A"] = a["launches"]

    # (b) Mode B at full width, cut in depth
    cut = dataclasses.replace(full, n_layers=POD_B_LAYERS)
    with FakeTensorMode():
        cut_sizes = [x.numel() for x in dpsgd._leaves(
            transformer.init_params(cut, torch.Generator(), "cpu"))]
    groups = len(dpsgd.mix_groups(cut_sizes))
    run_b = _pod_run("dpsgd")
    plan_b = choose_plan(("data",), (POD_NODES,), run_b.lambda_target,
                         bytes_per_rank=lt.param_bytes(cut),
                         eta=run_b.eta).plan
    print(f"22 (b): depth cut {full.n_layers} -> {POD_B_LAYERS} layers: "
          f"{sum(cut_sizes) / 1e6:.1f} M parameters a node, "
          f"{POD_NODES * sum(cut_sizes) * 4 / 1e9:.2f} GB a node-stacked "
          f"fp32 copy, {groups} rows-mix buffer groups; the controller's "
          f"plan {plan_b.name}")
    b = pod_loop(torch, cut, run_b, POD_NODES,
                 f"{POD_B_LAYERS} layers, the controller's plan",
                 "22 (b) Mode B (dpsgd)", POD_PEAK_GIB["b"])
    mixes = 0 if plan_b.kind == "allreduce" else groups
    want = {"flash_attention": POD_B_LAYERS * b["steps"],
            "flash_attention_bwd": POD_B_LAYERS * b["steps"],
            "gossip_mix": mixes * b["steps"]}
    check(b["launches"] == want, f"22 (b): launches {b['launches']}, want "
          f"{want} ({plan_b.name}: {mixes} rows mixes a step)")
    result["launches"]["(b) Mode B, the controller's plan"] = b["launches"]
    gc.collect()
    torch.cuda.empty_cache()

    api = build(cut, "cuda")
    plan = ring_plan(("data",), (POD_NODES,), 1)
    counters = pod_counters()
    for comp in ("none", "int8"):
        run = _pod_run("dpsgd", optimizer="sgd", eta=0.05, compression=comp)
        step_fn = ts.make_train_step(api, run, plan, constant_lr(run.eta))
        state = ts.init_train_state(api, run, torch.Generator(
            device="cuda").manual_seed(1), n_nodes=POD_NODES)
        # de-sync the nodes so the mix matters
        state["params"] = dpsgd._tree_map(
            lambda p: p * (1 + 0.01 * torch.arange(
                POD_NODES, device=p.device, dtype=p.dtype).reshape(
                    -1, *[1] * (p.dim() - 1))), state["params"])
        batch = pod_batch(torch, cut, 0, POD_NODES, POD_BATCH, POD_SEQ,
                          "dpsgd")
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        new, m = step_fn(state, batch)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        want = {"flash_attention": POD_B_LAYERS,
                "flash_attention_bwd": POD_B_LAYERS, "gossip_mix": groups}
        print(f"22 (b) make_train_step, {plan.name} ({comp}): loss "
              f"{float(m['loss']):.4f}, launches {launches} (expected {want}: "
              f"one rows mix per buffer group of at most "
              f"{dpsgd.MIX_CONCAT_LANES} lanes a node, the compressed "
              f"receive over [x; deq] with W_cat (4 x 8); flash once a "
              f"layer for all nodes); peak {peak_gib:.3f} GiB")
        check(launches == want, f"22 (b) {comp}: launches {launches}, want "
              f"{want}")
        check(math.isfinite(float(m["loss"])), f"22 (b) {comp}: loss")
        result["launches"][f"(b) Mode B, {plan.name} {comp}"] = launches
        if comp == "int8":
            check(any(bool(x.any()) for x in dpsgd._leaves(new["residual"])),
                  "22 (b) int8: the residual stayed zero")
        else:
            # Eq. 5 twice: the trainer's step against core.dpsgd's
            ref, _ = dpsgd.dpsgd_step(api.loss, state["params"], batch,
                                      plan_w(plan), dpsgd.DPSGDConfig(
                                          eta=0.05))
            bad = [i for i, (x, y) in enumerate(zip(
                dpsgd._leaves(new["params"]), dpsgd._leaves(ref)))
                if not torch.allclose(x, y, rtol=2e-4, atol=2e-5)]
            d = max(err(x, y) for x, y in zip(dpsgd._leaves(new["params"]),
                                               dpsgd._leaves(ref)))
            print(f"22 (b) the SGD step against core.dpsgd.dpsgd_step with "
                  f"plan_w: max|diff| {d:.3e}, leaves outside rtol 2e-4 / "
                  f"atol 2e-5: {bad}")
            check(not bad, f"22 (b): the trainer's step and dpsgd_step "
                  f"differ at leaves {bad}")
            result["b_vs_dpsgd"] = d
            del ref
        del new, m, state, batch
        gc.collect()
        torch.cuda.empty_cache()
    del api

    # (b') eager against graphed in turns where a graph fits
    g_cfg = dataclasses.replace(full, n_layers=POD_GRAPH_LAYERS)
    g_api = build(g_cfg, "cuda")
    run = _pod_run("dpsgd", optimizer="sgd", eta=0.05)
    step_fn = ts.make_train_step(g_api, run, plan, constant_lr(run.eta))
    graphed = GraphedStep(step_fn)
    state = ts.init_train_state(g_api, run, torch.Generator(
        device="cuda").manual_seed(2), n_nodes=POD_NODES)
    batch = pod_batch(torch, g_cfg, 0, POD_NODES, POD_BATCH, POD_SEQ, "dpsgd")
    torch.cuda.reset_peak_memory_stats()
    graphed.prepare(state, batch)
    times = {"eager": [], "graphed": []}
    for i in range(2 * POD_PAIRS):
        kind = ("eager", "graphed", "graphed", "eager")[i % 4]
        fn = step_fn if kind == "eager" else graphed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, m = fn(state, batch)
        float(m["loss"])
        times[kind].append((time.perf_counter() - t0) * 1e3)
        del out, m
    peak_g = torch.cuda.max_memory_allocated() / 2**30
    tokens = POD_NODES * POD_BATCH * POD_SEQ
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"22 (b') {POD_GRAPH_LAYERS} layer, {plan.name}, SGD, in turns: "
          f"eager {times['eager']} ms, graphed {times['graphed']} ms; "
          f"medians {med['eager']:.2f} / {med['graphed']:.2f} ms a step "
          f"({tokens / med['eager'] * 1e3:.0f} / "
          f"{tokens / med['graphed'] * 1e3:.0f} tokens/s); peak "
          f"{peak_g:.3f} GiB with the graph held")
    result["b_graph"] = {"eager_ms": med["eager"],
                         "graphed_ms": med["graphed"], "peak_gib": peak_g}
    del graphed, step_fn, fn, state, batch, g_api
    gc.collect()
    torch.cuda.empty_cache()
    # the profile of (b)'s eager step at its cut
    api = build(cut, "cuda")
    state = ts.init_train_state(api, run_b, torch.Generator(
        device="cuda").manual_seed(0), n_nodes=POD_NODES)
    b["profile"] = pod_profile(
        torch, ts.make_train_step(api, run_b, plan_b,
                                  constant_lr(run_b.eta)), state,
        pod_batch(torch, cut, 0, POD_NODES, POD_BATCH, POD_SEQ, "dpsgd"),
        b["ms"], f"22 (b) ({plan_b.name})")
    del state, api
    gc.collect()
    torch.cuda.empty_cache()
    result["b"] = b

    # (c) the smoke widths, card against CPU
    smoke = reduce_for_smoke(full)
    result["c"] = {}
    sgd = dict(optimizer="sgd", eta=0.05)
    for name, run in (
            ("Mode A, AdamW", _pod_run("allreduce", eta=POD_LOCK_ETA)),
            ("Mode B none, AdamW", _pod_run("dpsgd", eta=POD_LOCK_ETA)),
            ("Mode B none, SGD", _pod_run("dpsgd", **sgd)),
            ("Mode B bf16, SGD", _pod_run("dpsgd", compression="bf16",
                                          **sgd)),
            ("Mode B int8, SGD", _pod_run("dpsgd", compression="int8",
                                          **sgd)),
            ("Mode B microbatch 2, SGD", _pod_run("dpsgd", microbatch=2,
                                                  **sgd))):
        result["c"][name] = pod_lockstep(torch, name, run, smoke)
    kw = dict(nodes=POD_NODES, tp=1, batch_per_node=POD_LOCK_BATCH,
              seq_len=POD_LOCK_SEQ, log_every=1)
    # the fault drill from one initial state (the card's and the host's
    # generators draw different streams): a step-0 checkpoint both resume
    run = _pod_run("dpsgd", **sgd)
    with tempfile.TemporaryDirectory() as ck0:
        save(ck0, 0, ts.init_train_state(
            build(smoke, "cuda"), run,
            torch.Generator(device="cuda").manual_seed(run.seed),
            n_nodes=POD_NODES))
        card = lt.train_loop(smoke, run, steps=5, ckpt_dir=ck0,
                             ckpt_every=100, resume=True, fail_at=3,
                             fail_node=2, device="cuda", **kw)
        host = lt.train_loop(smoke, run, steps=5, ckpt_dir=ck0,
                             ckpt_every=100, resume=True, fail_at=3,
                             fail_node=2, device="cpu", **kw)
    drill_d = max(abs(x["loss"] - y["loss"])
                  for x, y in zip(card["log"], host["log"]))
    print(f"22 (c) the fault drill (node 2 dies at step 3, SGD): card "
          f"losses {[r['loss'] for r in card['log']]}, CPU "
          f"{[r['loss'] for r in host['log']]}: max|diff| {drill_d:.3e} "
          f"(tol {LOCK_TOL:g}, free-running)")
    check(len(card["log"]) == 5 and drill_d <= LOCK_TOL,
          f"22 (c) fault drill: card {card['log']}, CPU {host['log']}")
    run = _pod_run("dpsgd", compression="int8")
    with tempfile.TemporaryDirectory() as ck:
        straight = lt.train_loop(smoke, run, steps=4, ckpt_dir=None,
                                 device="cuda", **kw)
        lt.train_loop(smoke, run, steps=2, ckpt_dir=ck, ckpt_every=2,
                      device="cuda", **kw)
        resumed = lt.train_loop(smoke, run, steps=4, ckpt_dir=ck,
                                resume=True, device="cuda", **kw)
    got = [r["loss"] for r in resumed["log"]]
    want = [r["loss"] for r in straight["log"][2:]]
    same = got == want
    d = max(abs(x - y) for x, y in zip(got, want))
    print(f"22 (c) checkpoint at step 2, resume=True: steps 3-4 losses {got}"
          f" against the uninterrupted {want}: "
          f"{'bit-equal' if same else f'max|diff| {d:.3e}'}")
    check([r["step"] for r in resumed["log"]] == [3, 4] and d <= LOCK_TOL,
          f"22 (c) resume: {resumed['log']} against {straight['log']}")
    result["c"]["resume_bit_equal"] = same
    result["c"]["fault_drill_diff"] = drill_d
    # (c') the trainer where a graph fits: the smoke widths, Mode B with
    # AdamW and the controller's plan, eager against graphed in turns
    run = _pod_run("dpsgd")
    times = {"eager": [], "graphed": []}
    for i in range(2 * POD_PAIRS):
        kind = ("eager", "graphed", "graphed", "eager")[i % 4]
        out = lt.train_loop(smoke, run, steps=POD_WARM + POD_TIMED,
                            ckpt_dir=None, device="cuda",
                            graphed=kind == "graphed", **kw)
        walls = [r["wall_s"] for r in out["log"]]
        times[kind].append((walls[-1] - walls[POD_WARM - 1]) * 1e3
                           / POD_TIMED)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"22 (c') train_loop at the smoke widths ({POD_NODES} nodes x "
          f"{POD_LOCK_BATCH} x {POD_LOCK_SEQ} tokens, AdamW), ms a step over "
          f"the last {POD_TIMED} of {POD_WARM + POD_TIMED} (a loss read each "
          f"step), in turns: eager {times['eager']}, graphed "
          f"{times['graphed']}; medians {med['eager']:.3f} / "
          f"{med['graphed']:.3f} ms (graphed / eager "
          f"{med['graphed'] / med['eager']:.4f})")
    result["c_graph"] = {"eager_ms": med["eager"],
                         "graphed_ms": med["graphed"]}
    gc.collect()
    torch.cuda.empty_cache()
    return result


def remat_unit_calls(cfg) -> dict:
    """The forward kernel calls of one step inside checkpointed units,
    which remat "full" makes twice (the forward and the recompute): the
    decoder-only stack's pattern units, every encoder-decoder layer."""
    from repro_torch.models import transformer

    if cfg.is_encdec:
        n_enc = cfg.encoder_layers
        return {"flash_attention": n_enc + 2 * (cfg.n_layers - n_enc),
                "rglru_scan": 0, "rwkv6_scan": 0}
    pro, repeats, _ = transformer.layer_groups(cfg)
    kinds = transformer.layer_kinds(cfg)[pro:pro + repeats * len(cfg.pattern)]
    return {"flash_attention": sum(k in ("global", "local") for k in kinds),
            "rglru_scan": kinds.count("rglru"),
            "rwkv6_scan": kinds.count("rwkv")}


def remat_want(none: dict, unit: dict, policy: str) -> dict:
    """A policy's launches from remat "none"'s: "full" adds each forward
    kernel call of a checkpointed unit once more, "dots" none."""
    if policy != "full":
        return dict(none)
    return {k: n + unit.get(k, 0) for k, n in none.items()}


def remat_policy_steps(torch, what: str, cfg, api, run, state, batch,
                       plan=None) -> dict:
    """One step per remat policy from ``state``: full and dots held
    against none (losses 1e-4, parameters 1e-5), the launches of each
    against none's with the recompute's added."""
    import dataclasses

    from repro_torch.core import dpsgd
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import step as ts

    counters = train_counters()
    out = {}
    for policy in ("none", "full", "dots"):
        step = ts.make_train_step(api, dataclasses.replace(
            run, remat=policy), plan, constant_lr(run.eta))
        for c in counters.values():
            c.launches = 0
        new, m = step(state, batch)
        torch.cuda.synchronize()
        out[policy] = (new["params"], m["loss"],
                       {k: c.launches for k, c in counters.items()})
    ref, l0, n0 = out["none"]
    for base in ("flash_attention", "rglru_scan", "rwkv6_scan"):
        check(n0[base] == n0[f"{base}_bwd"], f"{what}: launches {n0}: each "
              f"forward kernel call needs its backward once")
    unit = remat_unit_calls(cfg)
    res = {"launches": {p: o[2] for p, o in out.items()}}
    for policy in ("full", "dots"):
        params, loss, n = out[policy]
        d_loss = err(loss, l0)
        pairs = list(zip(dpsgd._leaves(params), dpsgd._leaves(ref)))
        d_par = max(err(a, b) for a, b in pairs)
        bit = bool(torch.equal(loss, l0)) and all(torch.equal(a, b)
                                                  for a, b in pairs)
        want = remat_want(n0, unit, policy)
        print(f"{what} {policy} against none: loss {float(loss):.6f}, "
              f"max|loss diff| {d_loss:.3e} (tol {LOCK_TOL:g}), max|param "
              f"diff| {d_par:.3e} (tol {TOL_FP32:g}), "
              f"{'bit-equal' if bit else 'not bit-equal'}; launches "
              f"{ {k: v for k, v in n.items() if v} } (none: "
              f"{ {k: v for k, v in n0.items() if v} })")
        check(d_loss <= LOCK_TOL and d_par <= TOL_FP32,
              f"{what} {policy}: loss {d_loss}, parameters {d_par}")
        check(n == want, f"{what} {policy}: launches {n}, want {want}")
        res[policy] = {"loss_diff": d_loss, "param_diff": d_par,
                       "bit_equal": bit}
    return res


def hold_step(torch, what: str, got: dict, want: dict, prev: dict,
              lr: float, adamw: bool, held: dict | None = None) -> dict:
    """One optimizer step from the state ``prev`` taken two ways, ``got``
    against ``want``, at the lockstep bars (the work runs on ``want``'s
    device; ``got``'s and ``prev``'s leaves may lie elsewhere): residuals
    and parameters within TOL_FP32, every optimizer leaf within TOL_FP32
    of its leaf's max |x| (AdamW's m carries the gradient: (1 - b1) g at
    the first step, so a wrong gradient shows there). AdamW's step is
    lr r with r = m^ / (sqrt(v^) + eps): where sqrt(v^) is near the
    rounding noise of the gradient's sums, two sums of the same gradient
    give steps that differ by a fraction of lr. Where the two sides' own
    steps are more than TOL_FP32 / 2 apart, the parameters are held within
    TOL_FP32 of that difference (each side's update from its own moments),
    the entries counted and the largest described with its gradients
    (g = (m' - b1 m) / (1 - b1)). ``held``, an earlier step's result, is
    folded in: the worst of each bar over the steps."""
    from repro_torch.core import dpsgd

    held = held or {"params": 0.0, "params_amplified": 0.0,
                    "residual": 0.0, "opt": 0.0, "amplified": 0,
                    "entries": 0, "amp_d": 0.0, "amp_worst": None}
    dev = dpsgd._leaves(want["params"])[0].device

    def on(x):
        return x.to(dev).double()

    for key in ("residual", "opt"):
        pairs = [dpsgd._leaves(s.get(key, {})) for s in (got, want)]
        check(len(pairs[0]) == len(pairs[1]), f"{what}: {key} leaves")
        for a, b in zip(*pairs):
            d = err(a.to(dev), b)
            scale = float(b.double().abs().max()) if key == "opt" else 1.0
            held[key] = max(held[key], d / scale if scale else
                            float("inf") if d else 0.0)
    paths = [p for p, _ in dpsgd._paths(want["params"])]
    # got's m, v; want's m, v; prev's m
    moments = [dpsgd._leaves(s["opt"][k]) for s, k in (
        (got, "m"), (got, "v"), (want, "m"), (want, "v"), (prev, "m"))] \
        if adamw else []
    t = float(want["opt"]["t"]) if adamw else 0.0

    def r_of(mm, vv):
        return (mm / (1 - ADAM_B1 ** t)) \
            / ((vv / (1 - ADAM_B2 ** t)) ** 0.5 + ADAM_EPS)

    for i, (a, b) in enumerate(zip(dpsgd._leaves(got["params"]),
                                   dpsgd._leaves(want["params"]))):
        d = on(a) - b.double()
        held["entries"] += d.numel()
        if not adamw:
            held["params"] = max(held["params"], float(d.abs().max()))
            continue
        dr = lr * (r_of(on(moments[0][i]), on(moments[1][i]))
                   - r_of(on(moments[2][i]), on(moments[3][i])))
        amp = dr.abs() > TOL_FP32 / 2
        held["amplified"] += int(amp.sum())
        if (~amp).any():
            held["params"] = max(held["params"], float(d.abs()[~amp].max()))
        if amp.any():
            held["params_amplified"] = max(
                held["params_amplified"], float((d + dr).abs()[amp].max()))
            j = int(torch.where(amp, d.abs(), torch.zeros_like(d)).argmax())
            if abs(float(d.reshape(-1)[j])) > held["amp_d"]:
                held["amp_d"] = abs(float(d.reshape(-1)[j]))
                m_a, v_a, m_b, v_b, m_0 = (float(x.reshape(-1)[j])
                                           for x in (y[i] for y in moments))
                g_b = (on(moments[2][i]) - ADAM_B1 * on(moments[4][i])) \
                    / (1 - ADAM_B1)
                held["amp_worst"] = (
                    f"{what} {paths[i]} flat {j}: gradient "
                    f"{(m_a - ADAM_B1 * m_0) / (1 - ADAM_B1):.4e} against "
                    f"{(m_b - ADAM_B1 * m_0) / (1 - ADAM_B1):.4e} (the "
                    f"leaf's median |g| {float(g_b.abs().median()):.3e}), "
                    f"sqrt(v^) {(v_b / (1 - ADAM_B2 ** t)) ** 0.5:.3e}; "
                    f"parameter {float(a.reshape(-1)[j]):.9e} against "
                    f"{float(b.reshape(-1)[j]):.9e}, lr r "
                    f"{lr * r_of(m_a, v_a):.6e} against "
                    f"{lr * r_of(m_b, v_b):.6e}")
                del g_b
        del d, dr, amp
    return held


def report_held(what: str, held: dict, adamw: bool) -> None:
    """Print :func:`hold_step`'s result and fail past its bars."""
    print(f"{what}: max|param diff| {held['params']:.3e} (tol "
          f"{TOL_FP32:g}), max|residual diff| {held['residual']:.3e}, "
          f"optimizer state max|diff| / its leaf's max|x| "
          f"{held['opt']:.3e} (tol {TOL_FP32:g})")
    if adamw:
        print(f"{what}: {held['amplified']} of {held['entries']} parameter "
              f"entries had two AdamW steps lr r more than "
              f"{TOL_FP32 / 2:g} apart (max|diff| {held['amp_d']:.3e}); "
              f"their parameters against each side's own step: max|diff + "
              f"lr dr| {held['params_amplified']:.3e} (tol {TOL_FP32:g}); "
              f"the largest: {held['amp_worst']}")
    check(max(held["params"], held["residual"], held["opt"],
              held["params_amplified"]) <= TOL_FP32,
          f"{what}: the two steps differ: "
          f"{ {k: v for k, v in held.items() if k != 'amp_worst'} }")


def remat_in_turns(torch, what: str, steps: dict, init_state, batch,
                   tokens: int) -> tuple[dict, object]:
    """Each step of ``steps`` once to warm it, then REMAT_TURNS turns (the
    order reversed every other turn), the state (``init_state()``, made
    here: a caller's reference would keep a third state alive in every
    step) carried through: ms a step (host clock, the loss read), peak GiB
    of its calls, launches a step, the state's parameter and optimizer
    bytes."""
    import gc
    import math

    counters = pod_counters()
    times = {k: [] for k in steps}
    peak = {k: 0.0 for k in steps}
    base = {}
    launches = {}
    order = list(steps)
    state = init_state()
    state_bytes = tuple(sum(x.numel() * x.element_size()
                            for x in tree_leaves(state[k]))
                        for k in ("params", "opt"))
    for turn in range(REMAT_TURNS + 1):
        for name in (order if turn % 2 == 0 else order[::-1]):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base[name] = torch.cuda.memory_allocated()
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            state, m = steps[name](state, batch)
            loss = float(m["loss"])
            ms = (time.perf_counter() - t0) * 1e3
            check(math.isfinite(loss), f"{what} {name}: loss {loss}")
            peak[name] = max(peak[name],
                             torch.cuda.max_memory_allocated() / 2**30)
            launches[name] = {k: c.launches for k, c in counters.items()}
            if turn:
                times[name].append(ms)
    out = {}
    for name, ts_ in times.items():
        med = statistics.median(ts_)
        out[name] = {"ms": med, "ms_turns": ts_, "tokens_per_s":
                     tokens / med * 1e3, "peak_gib": peak[name],
                     "base_bytes": base[name], "launches": launches[name],
                     "state_bytes": state_bytes}
        print(f"{what} {name}: {ts_} ms a step in turns, median {med:.2f} "
              f"ms, {tokens / med * 1e3:.0f} tokens/s; peak {peak[name]:.3f}"
              f" GiB; launches a step {launches[name]}")
    return out, state


def phase_remat(torch) -> dict:
    phase("23. activation checkpointing (remat none / full / dots, "
          "models.remat) through the kernels' recompute: every family at "
          "the smoke widths, qwen2-vl-2b's full-depth Mode A step in one "
          "microbatch, Mode B at 4 layers")
    import dataclasses
    import gc

    from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
    from repro_torch.core import dpsgd
    from repro_torch.core.density_controller import choose_plan
    from repro_torch.core.gossip import ring_plan
    from repro_torch.graphs import GraphedStep
    from repro_torch.launch import train as lt
    from repro_torch.models import build
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import step as ts

    result: dict = {"a": {}}
    cuda = torch.device("cuda")
    sgd = RunConfig(mode="allreduce", optimizer="sgd", eta=0.05,
                    remat="none")
    # (a) every family at the smoke widths, Mode A
    for arch in REMAT_ARCHS:
        cfg = reduce_for_smoke(get_config(arch))
        if arch in REMAT_DEEPER:
            cfg = dataclasses.replace(cfg, n_layers=REMAT_DEEPER[arch])
        api = build(cfg, "cuda")
        state = ts.init_train_state(api, sgd, torch.Generator(
            device="cuda").manual_seed(0))
        batch = lt._batch(cfg, sgd, 0, REMAT_BATCH, REMAT_SEQ, cuda)
        result["a"][arch] = remat_policy_steps(
            torch, f"23 (a) {arch} ({cfg.n_layers} layers) Mode A", cfg,
            api, sgd, state, batch)
    # Mode B ring-1 under vmap, de-synced nodes
    cfg = dataclasses.replace(reduce_for_smoke(get_config(POD_ARCH)),
                              n_layers=REMAT_DEEPER[POD_ARCH])
    api = build(cfg, "cuda")
    run = dataclasses.replace(sgd, mode="dpsgd")
    state = ts.init_train_state(api, run, torch.Generator(
        device="cuda").manual_seed(1), n_nodes=POD_NODES)
    state["params"] = dpsgd._tree_map(
        lambda p: p * (1 + 0.01 * torch.arange(
            POD_NODES, device=p.device, dtype=p.dtype).reshape(
                -1, *[1] * (p.dim() - 1))), state["params"])
    batch = pod_batch(torch, cfg, 0, POD_NODES, POD_LOCK_BATCH,
                      POD_LOCK_SEQ, "dpsgd")
    plan = ring_plan(("data",), (POD_NODES,), 1)
    result["a"]["Mode B"] = remat_policy_steps(
        torch, f"23 (a) {POD_ARCH} ({cfg.n_layers} layers) Mode B ring-1 "
        f"({POD_NODES} nodes, vmap)", cfg, api, run, state, batch, plan)
    # the checkpoint inside a CUDA graph: the graphed step against eager
    full_run = dataclasses.replace(run, remat="full")
    outs = [fn(state, batch) for fn in (
        GraphedStep(ts.make_train_step(api, full_run, plan,
                                       constant_lr(run.eta))),
        ts.make_train_step(api, full_run, plan, constant_lr(run.eta)))]
    d_graph = max(err(a, b) for a, b in zip(
        *(dpsgd._leaves(o[0]["params"]) for o in outs)))
    d_loss = err(outs[0][1]["loss"], outs[1][1]["loss"])
    print(f"23 (a) Mode B remat full as a CUDA graph (GraphedStep) against "
          f"eager: max|loss diff| {d_loss:.3e}, max|param diff| "
          f"{d_graph:.3e}")
    check(d_loss <= LOCK_TOL and d_graph <= TOL_FP32,
          f"23 (a) graphed remat: loss {d_loss}, parameters {d_graph}")
    result["a_graphed_vs_eager"] = d_graph
    del api, state, batch, outs
    gc.collect()
    torch.cuda.empty_cache()

    # (b) qwen2-vl-2b at its published widths and full depth, Mode A
    full = get_config(POD_ARCH)
    api = build(full, "cuda")
    runs = {p: dataclasses.replace(_pod_run(
        "allreduce", microbatch=REMAT_MICROBATCH[p]), remat=p)
        for p in ("none", "full", "dots")}

    def init_state():
        return ts.init_train_state(api, runs["none"], torch.Generator(
            device="cuda").manual_seed(0))
    state = init_state()
    batch = pod_batch(torch, full, 0, POD_NODES, POD_BATCH, POD_SEQ,
                      "allreduce")
    tokens = POD_NODES * POD_BATCH * POD_SEQ
    # full at POD_A_MICROBATCH against none there, one step from one state
    # (the first result's moments wait on the host meanwhile)
    held = {}
    for policy in ("full", "none"):
        step = ts.make_train_step(api, dataclasses.replace(
            runs["none"], remat=policy), None, constant_lr(runs["none"].eta))
        new, m = step(state, batch)
        held[policy] = (new, m["loss"])
        if policy == "full":
            new["opt"] = {**new["opt"], "m": tree_to(new["opt"]["m"], "cpu"),
                          "v": tree_to(new["opt"]["v"], "cpu")}
        del new, m, step
        gc.collect()
    d_loss = err(held["full"][1], held["none"][1])
    print(f"23 (b) {POD_ARCH} {full.n_layers} layers, full against none at "
          f"{POD_A_MICROBATCH} microbatches, one AdamW step from one state: "
          f"losses {float(held['full'][1]):.6f} / "
          f"{float(held['none'][1]):.6f}, max|diff| {d_loss:.3e} (tol "
          f"{LOCK_TOL:g})")
    check(d_loss <= LOCK_TOL, f"23 (b) hold: loss {d_loss}")
    result["b_hold"] = hold_step(
        torch, "23 (b)", held["full"][0], held["none"][0], state,
        runs["none"].eta, True)
    report_held("23 (b) full against none", result["b_hold"], True)
    result["b_hold"]["loss_diff"] = d_loss
    del held, state
    gc.collect()
    torch.cuda.empty_cache()
    names = {p: f"{p} at {REMAT_MICROBATCH[p]} microbatch"
             f"{'es' if REMAT_MICROBATCH[p] > 1 else ''}" for p in runs}
    steps = {names[p]: ts.make_train_step(api, r, None, constant_lr(r.eta))
             for p, r in runs.items()}
    b, state = remat_in_turns(
        torch, f"23 (b) {POD_ARCH} Mode A {full.n_layers} layers "
        f"{POD_NODES * POD_BATCH} x {POD_SEQ} AdamW", steps, init_state,
        batch, tokens)
    for p in runs:
        want = {"flash_attention": full.n_layers * (
                    REMAT_MICROBATCH[p] * (2 if p == "full" else 1)),
                "flash_attention_bwd": full.n_layers * REMAT_MICROBATCH[p],
                "gossip_mix": 0}
        check(b[names[p]]["launches"] == want, f"23 (b) {names[p]}: "
              f"launches {b[names[p]]['launches']}, want {want}")
        gc.collect()
        torch.cuda.empty_cache()
        b[names[p]]["profile"] = pod_profile(
            torch, steps[names[p]], state, batch, b[names[p]]["ms"],
            f"23 (b) {names[p]}")
    result["b"] = b
    result["b_names"] = names
    del api, state, batch, steps
    gc.collect()
    torch.cuda.empty_cache()

    # (c) Mode B at 4 layers, the controller's plan, none against full
    cut = dataclasses.replace(full, n_layers=POD_B_LAYERS)
    api = build(cut, "cuda")
    run_b = _pod_run("dpsgd")
    plan_b = choose_plan(("data",), (POD_NODES,), run_b.lambda_target,
                         bytes_per_rank=lt.param_bytes(cut),
                         eta=run_b.eta).plan
    batch = pod_batch(torch, cut, 0, POD_NODES, POD_BATCH, POD_SEQ, "dpsgd")
    steps = {p: ts.make_train_step(api, dataclasses.replace(run_b, remat=p),
                                   plan_b, constant_lr(run_b.eta))
             for p in ("none", "full")}
    result["c"], state = remat_in_turns(
        torch, f"23 (c) Mode B {POD_B_LAYERS} layers ({plan_b.name})",
        steps, lambda: ts.init_train_state(api, run_b, torch.Generator(
            device="cuda").manual_seed(0), n_nodes=POD_NODES), batch, tokens)
    del api, state, batch, steps
    gc.collect()
    torch.cuda.empty_cache()
    return result


# the inspection tooling on the card (phase 24): each dry-run peak within
# INSPECT_PEAK_TOL of the card's torch.cuda.max_memory_allocated for the
# same configuration, read where phases 8, 12 and 23 ran it
INSPECT_PEAK_TOL = 0.10
# qwen2-vl-2b's Mode A step (remat none, AdamW, 16 x 512) ran out of the
# card at 1 microbatch and peaked at 77.0 GiB of its 79.2 at 2 (PR 27's
# probe, H100 80GB HBM3, 700 W; PERF.md): the dry run's fewest
# microbatches must answer 2, its trial at 2 within INSPECT_PEAK_TOL of
# that peak
POD_A_FEWEST, POD_A_FEWEST_PEAK_GIB = 2, 77.0


def dry_cell(torch, what: str, fn) -> dict:
    """One dry run (``launch.dryrun``) of a configuration on data-free
    tensors, with the card as the fake device and again with the CPU: the
    two must agree in every byte, flop and launch."""
    t0 = time.perf_counter()
    on_card = fn(torch.device("cuda", 0))
    t1 = time.perf_counter()
    on_cpu = fn(torch.device("cpu"))
    keys = ("peak_bytes", "end_bytes", "base_bytes", "params_bytes",
            "opt_bytes", "flops", "kernel_launches")
    same = all(on_card[k] == on_cpu[k] for k in keys)
    print(f"{what}: dry run {t1 - t0:.2f} s on the host (fake device "
          f"{on_card['fake_device']}), again with the CPU as the fake device:"
          f" {'the same' if same else 'DIFFERENT'} bytes, flops and launches")
    check(same, f"24 {what}: the dry run differs by fake device: "
          f"{ {k: (on_card[k], on_cpu[k]) for k in keys} }")
    return on_card


def hold_dry(what: str, dry: dict, rec: dict, traced: dict | None) -> dict:
    """A dry run against the card's record ``rec`` of the same
    configuration: the dry-run peak within INSPECT_PEAK_TOL of the card's
    ``max_memory_allocated`` (``peak_bytes``); the parameter and optimizer
    bytes equal to the card's state (``state_bytes``); the kernel
    launches equal to the wrappers' counters (``launches``, by the
    counters' labels), and the profiler's ``traced`` (read from the
    kernels' names; None where no step was traced) equal to them too.
    What the card held beyond the step's own state and batch at the
    reset (``base_bytes``) is printed beside the peak, not held."""
    names = {k: w.__name__ for k, w in train_counters().items()}
    peak, launches = rec["peak_bytes"], rec["launches"]
    held = rec["base_bytes"] - dry["base_bytes"]
    rel = dry["peak_bytes"] / peak - 1.0
    state = (dry["params_bytes"], dry["opt_bytes"])
    dry_l = {k: dry["kernel_launches"].get(names.get(k, k), 0)
             for k in launches}
    traced_l = None if traced is None else \
        {k: traced.get(names.get(k, k), 0) for k in launches}
    print(f"{what}: peak dry {dry['peak_bytes'] / 2**30:.3f} GiB against "
          f"max_memory_allocated {peak / 2**30:.3f} GiB: {rel * 100:+.2f} % "
          f"(bar {INSPECT_PEAK_TOL * 100:g} %); the card held "
          f"{held / 2**30:.3f} GiB beyond the state and batch at the reset "
          f"(dry + that: {(dry['peak_bytes'] + held) / 2**30:.3f} GiB); "
          f"parameter and optimizer bytes dry {state}, card "
          f"{rec['state_bytes']}; launches dry {dry_l}, counters "
          f"{launches}, profiler {traced_l}; flops {dry['flops']:.4e} "
          f"({dry['flops_kernels']:.4e} in the kernels)")
    check(abs(rel) <= INSPECT_PEAK_TOL, f"24 {what}: dry-run peak "
          f"{dry['peak_bytes']} against {peak} bytes ({rel * 100:+.2f} %)")
    check(state == tuple(rec["state_bytes"]), f"24 {what}: dry-run "
          f"parameter and optimizer bytes {state}, card {rec['state_bytes']}")
    check(dry_l == launches, f"24 {what}: dry-run launches {dry_l}, "
          f"counters {launches}")
    check(traced_l in (None, launches), f"24 {what}: profiler launches "
          f"{traced_l}, counters {launches}")
    return {"dry_peak_gib": dry["peak_bytes"] / 2**30,
            "held_gib": held / 2**30, "card_peak_gib": peak / 2**30,
            "rel": rel, "launches": launches, "dry_launches": dry_l,
            "traced_launches": traced_l, "flops": dry["flops"],
            "state_gib": sum(state) / 2**30,
            "end_gib": dry["end_bytes"] / 2**30,
            "collectives": dry.get("collectives")}


def phase_inspection(torch, remat_run: dict, served: dict) -> dict:
    """24. The inspection tooling against the card: the dry run of each
    configuration phases 8, 12 and 23 ran (qwen2-vl-2b's full-depth Mode A
    step under remat full x 1 and none x 4, its Mode B step at 4 layers,
    rwkv6-7b's and deepseek-v2-lite-16b's serve), its peak against their
    max_memory_allocated, its parameter and optimizer bytes against their
    state's, its launches against their counters, and the profiler's
    launches (read from the kernels' names in phase 23's and the serves'
    traces) against the counters too; and its fewest microbatches for
    Mode A under remat none against the card's."""
    phase("24. inspection tooling: the dry run and the profiler summary "
          "against the card")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.density_controller import choose_plan
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import train as lt

    props = torch.cuda.get_device_properties(0)
    mem = subprocess.run(["nvidia-smi", "--query-gpu=memory.total",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{props.name}: torch total_memory {props.total_memory} bytes "
          f"({props.total_memory / 2**30:.3f} GiB), nvidia-smi memory.total "
          f"{mem}; the dry run's constant for a host without a card "
          f"{dr.H100_BYTES}")
    out = {"capacity_bytes": props.total_memory}
    full = get_config(POD_ARCH)
    tokens = POD_NODES * POD_BATCH
    cells = {}
    for p in ("full", "none"):
        rec = remat_run["b"][remat_run["b_names"][p]]
        run = dataclasses.replace(_pod_run(
            "allreduce", microbatch=REMAT_MICROBATCH[p]), remat=p)
        what = (f"{POD_ARCH} Mode A {full.n_layers} layers, {tokens} x "
                f"{POD_SEQ}, AdamW, remat {p} x {REMAT_MICROBATCH[p]}")
        dry = dry_cell(torch, what, lambda dev, run=run: dr.train_cell(
            full, run, batch=tokens, seq_len=POD_SEQ, device=dev))
        out[f"mode_a_{p}"] = hold_dry(
            what, dry, {**rec, "peak_bytes": rec["peak_gib"] * 2**30},
            rec["profile"]["traced_launches"])
        cells[p] = run, dry
    # the fewest microbatches that fit the card, by the dry run's search
    # from the none x 4 record
    run, dry = cells["none"]
    t0 = time.perf_counter()
    m, tried = dr.fewest_microbatches(
        full, run, dry, batch=tokens, seq_len=POD_SEQ, nodes=1, plan=None,
        capacity=props.total_memory, device=torch.device(dry["fake_device"]))
    at = tried.get(POD_A_FEWEST, 0) / 2**30
    rel = at / POD_A_FEWEST_PEAK_GIB - 1.0
    print(f"{POD_ARCH} Mode A remat none: the fewest microbatches that fit "
          f"{props.total_memory / 2**30:.3f} GiB: {m} (the card's: "
          f"{POD_A_FEWEST}), trials "
          f"{ {k: round(v / 2**30, 3) for k, v in sorted(tried.items())} } "
          f"GiB; at {POD_A_FEWEST} {at:.3f} against the card's "
          f"{POD_A_FEWEST_PEAK_GIB} GiB: {rel * 100:+.2f} %; "
          f"{time.perf_counter() - t0:.2f} s on the host")
    check(m == POD_A_FEWEST, f"24: the dry run's fewest microbatches {m}, "
          f"the card's {POD_A_FEWEST}")
    check(abs(rel) <= INSPECT_PEAK_TOL, f"24: the dry run's trial at "
          f"{POD_A_FEWEST} microbatches {at:.3f} GiB against the card's "
          f"{POD_A_FEWEST_PEAK_GIB}")
    out["fewest_microbatches"] = {"m": m, "tried_gib": {
        k: v / 2**30 for k, v in tried.items()}, "rel": rel}
    cut = dataclasses.replace(full, n_layers=POD_B_LAYERS)
    run_b = _pod_run("dpsgd")
    plan_b = choose_plan(("data",), (POD_NODES,), run_b.lambda_target,
                         bytes_per_rank=lt.param_bytes(cut),
                         eta=run_b.eta).plan
    rec = remat_run["c"]["none"]
    what = (f"{POD_ARCH} Mode B {POD_B_LAYERS} layers, {POD_NODES} nodes "
            f"({plan_b.name}), remat none")
    dry = dry_cell(torch, what, lambda dev: dr.train_cell(
        cut, dataclasses.replace(run_b, remat="none"), batch=tokens,
        seq_len=POD_SEQ, nodes=POD_NODES, plan=plan_b, device=dev))
    # phase 23 (c) traces no step: the profiler is held on (b)'s and the
    # serves' traces
    out["mode_b"] = hold_dry(
        what, dry, {**rec, "peak_bytes": rec["peak_gib"] * 2**30}, None)
    for arch, res in served.items():
        what = (f"{arch} serving {SERVE_BATCH} x {SERVE_PROMPT} + "
                f"{SERVE_GEN} tokens (prefill and one decode step dry)")
        dry = dry_cell(torch, what, lambda dev, arch=arch: dr.serve_cell(
            get_config(arch), batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
            max_len=SERVE_PROMPT + SERVE_GEN, device=dev))
        out[arch] = hold_dry(what, dry, res, res["prefill_traced"])
    return out


# ---------------------------------------------------------------------------
# The node axis over a torch.distributed world (phase 25)
# ---------------------------------------------------------------------------

# (a) a world of one on the card (NCCL): the trainer at 22 (c)'s smoke
# widths and the smoke family of phase 17 with a mesh, bit-equal to the
# one-device runs; (b) the per-rank receive of a four-rank ring emulated
# in one process, each rank's buffers built as the exchange hands them
# over, through the port's receive halves; (c) with four cards, worlds of
# 4, 2 and 3 ranks (one card a rank) started by torchrun: the gossip,
# qwen2-vl-2b's Mode B at full depth one node a card and its state's
# gather to rank 0's host, the real-model smoke, stablelm-3b's
# compressed_int8 family at 1 layer of its published widths, the Mode B
# step's capture and train_loop over the fleet
FLEET_CARDS = 4
FLEET_STEPS = 4                      # (a) trainer steps
FLEET_RECV_LANES = 1 << 22           # (b) lanes of one rank's receive
FLEET_WARM, FLEET_TIMED = 1, 3       # (c) qwen2-vl-2b Mode B steps
FLEET_FAMILY_RANKS = 3               # (c) 6 nodes do not divide over 4
FLEET_CALL_S = 900                   # (c) each world's time limit


def fleet_counters() -> dict:
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import quantize as qz

    return {**pod_counters(), "quantize_int8_ef": qz.quantize_int8_ef,
            "gossip_mix_q8": gm.gossip_mix_q8_rows}


def launched(torch, fn, counters=None):
    """``fn()`` with every counter (``fleet_counters()`` unless given) set
    to 0 just before it and read just after: (its result, the launches)."""
    counters = counters or fleet_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def fleet_world_of_one(torch) -> dict:
    """25 (a): a world of one rank (NCCL) runs the one-device path."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import dpsgd
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import train as lt
    from repro_torch.sim import batch as tb
    from repro_torch.sim import get_scenario, precompute_traces

    smoke = reduce_for_smoke(get_config(POD_ARCH))
    kw = dict(nodes=POD_NODES, tp=1, steps=FLEET_STEPS,
              batch_per_node=POD_LOCK_BATCH, seq_len=POD_LOCK_SEQ,
              ckpt_dir=None, log_every=1, device="cuda")
    ad = tb.transformer_adapter(TRAIN_ARCH, batch=TRAIN_BATCH,
                                seq_len=LOCK_TRAIN_SEQ, device="cuda")
    cfg = get_scenario("static", model_bits=ad.model_bits,
                       model_shapes=ad.param_shapes,
                       eval_every_rounds=LOCK_TRAIN_ROUNDS)
    traces = precompute_traces([cfg], LOCK_TRAIN_ROUNDS)

    def runs(mesh) -> dict:
        out = {}
        for comp in ("none", "int8"):
            out[comp] = launched(torch, lambda: lt.train_loop(
                smoke, _pod_run("dpsgd", compression=comp), **kw))
        tb._STEPS.clear()        # capture the family's graph afresh
        out["family"] = launched(torch, lambda: tb.train_model_on_traces(
            ad, [cfg], LOCK_TRAIN_ROUNDS, trace_batch=traces, mesh=mesh,
            device="cuda")[1])
        return out

    one = runs(None)
    with tempfile.TemporaryDirectory() as d:
        lm.init_world("cuda", init_method=f"file://{d}/store", rank=0,
                      world_size=1)
        try:
            print(f"25 (a) a world of {dist.get_world_size()} rank, backend "
                  f"{dist.get_backend()}, every node on cuda:"
                  f"{torch.cuda.current_device()}")
            world = runs(lm.make_fleet_mesh(1, 1))
        finally:
            dist.destroy_process_group()
    tb._STEPS.clear()
    result = {}
    for comp in ("none", "int8"):
        (a, la), (b, lb) = one[comp], world[comp]
        same = [r["loss"] for r in a["log"]] == [r["loss"] for r in b["log"]]
        print(f"25 (a) train_loop, the controller's plan, {comp}: losses "
              f"{[r['loss'] for r in b['log']]} in the world of one, "
              f"{'bit-equal to' if same else 'UNLIKE'} the one-device run's;"
              f" launches {lb} against {la}")
        check(same and la == lb, f"25 (a) train_loop {comp}: world {b['log']}"
              f" {lb}, one device {a['log']} {la}")
        result[f"train_loop {comp}"] = lb
    (a, la), (b, lb) = one["family"], world["family"]
    same = np.array_equal(a["losses"], b["losses"]) and np.array_equal(
        a["acc"], b["acc"]) and all(
        torch.equal(x, y) for x, y in zip(dpsgd._leaves(a["final_params"]),
                                          dpsgd._leaves(b["final_params"])))
    print(f"25 (a) train_model_on_traces(mesh=(1, 1)) on static, "
          f"{TRAIN_ARCH}'s smoke config, {LOCK_TRAIN_ROUNDS} rounds: losses "
          f"{b['losses'][0].tolist()}, "
          f"{'bit-equal to' if same else 'UNLIKE'} the one-device family "
          f"(losses, accuracy, final parameters); launches {lb} against {la}")
    check(same and la == lb, f"25 (a) family: launches {lb} against {la}")
    result["family static"] = lb
    return result


def fleet_receives(torch) -> dict:
    """25 (b): each rank's receive of a four-rank ring, one node a rank,
    emulated in one process: for each rank, the rows each exchange hands
    it, through the port's receive halves: ``core.gossip.mix_received``
    (``gossip_mix_array``'s, and ``compressed_gossip_mix_array``'s bf16),
    ``core.compression.receive_q8`` (its int8: the neighbours' sends of
    ``quantize_int8_ef``), and the family's over gathered payloads,
    ``core.dpsgd.receive_q8_block`` / ``receive_bf16_block``; each held
    against its plain version and the float64 rows of plan_w @ X (of the
    dequantized payloads)."""
    from repro_torch.core import compression as cp
    from repro_torch.core import dpsgd
    from repro_torch.core.gossip import (_round_weights, mix_received,
                                         plan_w, ring_plan)
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import quantize as qz

    plan = ring_plan(("data",), (FLEET_CARDS,), 1)
    n, lanes = plan.n_nodes, FLEET_RECV_LANES
    g = torch.Generator(device="cuda").manual_seed(25)
    x = torch.randn(n, lanes, generator=g, device="cuda")
    res = 0.01 * torch.randn(n, lanes, generator=g, device="cuda")
    w = torch.as_tensor(plan_w(plan), dtype=torch.float32, device="cuda")
    w64 = w.double()
    want = w64 @ x.double()
    w_rank = _round_weights(plan, 1, x.device)
    w_self, w_off = w_rank[:, 0], w_rank[:, 1:]
    live = torch.ones(1, dtype=torch.bool, device="cuda")
    # every rank's send: its own row through the send kernel
    sends, s_launches = launched(torch, lambda: [
        qz.quantize_int8_ef(x[j:j + 1], res[j:j + 1], live)
        for j in range(n)])
    q_all = torch.cat([q for q, _, _ in sends])
    s_all = torch.cat([sc for _, sc, _ in sends])
    deq_all = (q_all.double().reshape(n, -1, 2048)
               * s_all.double()[..., None]).reshape(n, -1)[:, :lanes]
    msg_all = x.to(torch.bfloat16)
    worst = {k: 0.0 for k in ("rows_plain", "rows_w", "q8_plain", "q8_w",
                              "fam_q8_plain", "fam_q8_w", "fam_bf16_plain",
                              "fam_bf16_w")}

    def worse(key, got, ref):
        worst[key] = max(worst[key], err(got, ref))

    launches = {"gossip_mix": 0, "gossip_mix_q8": 0}
    for r in range(n):
        # the node each round's permutation brings to rank r
        src = [next(s for s, d in rnd.perm(plan.node_shape) if d == r)
               for rnd in plan.rounds]
        mine = x[r:r + 1]
        recvs = [x[j:j + 1] for j in src]
        q_r = [sends[j][0] for j in src]
        s_r = [sends[j][1] for j in src]
        (got, got8, fam8, fam16), lr = launched(torch, lambda: (
            mix_received(mine, recvs, plan),
            cp.receive_q8(mine, q_r, s_r, plan),
            dpsgd.receive_q8_block(w, r, mine, q_all, s_all),
            dpsgd.receive_bf16_block(w, r, mine, msg_all)))
        for k in launches:
            launches[k] += lr[k]
        worse("rows_plain", got, gm.gossip_mix_rows_plain(
            w_rank, torch.cat([mine, *recvs])))
        worse("rows_w", got[0], want[r])
        worse("q8_plain", got8, gm.gossip_mix_q8_rows_plain(
            w_self, w_off, mine, torch.cat(q_r), torch.cat(s_r)))
        worse("q8_w", got8[0], w_self[0].double() * x[r].double()
              + (w_off[0].double()[:, None] * deq_all[src]).sum(0))
        off = w64[r].clone()
        off[r] = 0.0
        worse("fam_q8_plain", fam8, gm.gossip_mix_q8_rows_plain(
            w[r, r:r + 1], off[None].float(), mine, q_all, s_all))
        worse("fam_q8_w", fam8[0], w64[r, r] * x[r].double()
              + (off[:, None] * deq_all).sum(0))
        w_cat = torch.cat([w[r, r:r + 1], off.float()])[None]
        worse("fam_bf16_plain", fam16, gm.gossip_mix_rows_plain(
            w_cat, torch.cat([mine, msg_all.float()])))
        worse("fam_bf16_w", fam16[0], w64[r, r] * x[r].double()
              + (off[:, None] * msg_all.double()).sum(0))
    print(f"25 (b) the per-rank receive of a {n}-rank ring ({plan.name}, one "
          f"node of {lanes} fp32 lanes a rank), through the port's receive "
          f"halves: gossip.mix_received over [x; recv_1; recv_2] against its "
          f"plain version {worst['rows_plain']:.3e}, against plan_w @ X's row"
          f" {worst['rows_w']:.3e}; compression.receive_q8 of the "
          f"neighbours' sends against its plain version "
          f"{worst['q8_plain']:.3e}, against the float64 sum of the "
          f"dequantized payloads {worst['q8_w']:.3e}; the family's "
          f"dpsgd.receive_q8_block over the {n} gathered sends "
          f"{worst['fam_q8_plain']:.3e} / {worst['fam_q8_w']:.3e} and "
          f"receive_bf16_block over the bf16 messages "
          f"{worst['fam_bf16_plain']:.3e} / {worst['fam_bf16_w']:.3e} "
          f"(plain / float64; tol {TOL_FP32:g}); launches: send "
          f"{s_launches['quantize_int8_ef']}, rows {launches['gossip_mix']}, "
          f"q8 {launches['gossip_mix_q8']} (one send, two of each receive "
          f"a rank)")
    check(max(worst.values()) <= TOL_FP32, f"25 (b): {worst}")
    check(s_launches["quantize_int8_ef"] == n
          and launches["gossip_mix"] == 2 * n
          and launches["gossip_mix_q8"] == 2 * n,
          f"25 (b): launches send {s_launches}, receives {launches}")
    return {"worst": worst, "launches": {
        "quantize_int8_ef": s_launches["quantize_int8_ef"], **launches}}


def descendants(pid: int) -> list:
    """Every process below ``pid``, deepest first (from /proc)."""
    out = []
    for task in Path(f"/proc/{pid}/task").glob("*"):
        with contextlib.suppress(OSError):
            for child in (task / "children").read_text().split():
                out = descendants(int(child)) + [int(child)] + out
    return out


def torchrun(ranks: int, args: list, what: str,
             timeout: float = FLEET_CALL_S) -> str:
    """One world of ``ranks`` processes, one card each (torchrun's local
    rendezvous), within ``timeout`` s: its output, or a failure. On a
    timeout torchrun and every process below it are killed."""
    import os
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(ranks), *args]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        # torchrun's ranks run in sessions of their own: kill the tree
        for pid in [*descendants(proc.pid), proc.pid]:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
        out, _ = proc.communicate()
        print(out[-4000:])
        fail(f"{what}: no end within {timeout:g} s")
    if proc.returncode != 0:
        print(out[-8000:])
        fail(f"{what}: exit code {proc.returncode}")
    return out


def fleet_result(out: str, what: str) -> dict:
    """The JSON line a world's rank 0 printed last, tagged FLEET."""
    lines = [ln for ln in out.splitlines() if ln.startswith("FLEET ")]
    check(bool(lines), f"{what}: no FLEET line in its output")
    return json.loads(lines[-1][len("FLEET "):])


def fleet_four_cards(torch) -> dict:
    """25 (c): the worlds of 4, 2 and 3 ranks, one card a rank."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    script = str(ROOT / Path(__file__).name)
    result = {}
    out = torchrun(FLEET_CARDS, [script, "--fleet-rank", "four"],
                   "25 (c) four ranks")
    print("\n".join(ln for ln in out.splitlines()
                    if ln.startswith("25 (c)")))
    result["four"] = fleet_result(out, "25 (c) four ranks")
    out = torchrun(2, ["-m", "repro_torch.sim.real_model_smoke", "--json",
                       "--device", "cuda", "--fleet", "2", "--model", "1"],
                   "25 (c) real_model_smoke")
    report = json.loads([ln for ln in out.splitlines()
                         if ln.startswith("{")][-1])
    print(f"25 (c) real_model_smoke at fleet 2: ok {report['ok']}, "
          f"{report['devices_spanned']} cards spanned, parity "
          f"{report['parity']}")
    check(report["ok"] and report["devices_spanned"] >= 2,
          f"25 (c) real_model_smoke: {report}")
    result["real_model_smoke"] = report
    out = torchrun(FLEET_FAMILY_RANKS, [script, "--fleet-rank", "family"],
                   "25 (c) the stablelm-3b family")
    print("\n".join(ln for ln in out.splitlines()
                    if ln.startswith("25 (c)")))
    result["family"] = fleet_result(out, "25 (c) the stablelm-3b family")
    # train_loop runs the fleet's Mode B step as a CUDA graph on the card
    out = torchrun(FLEET_CARDS, [script, "--fleet-rank", "trainer"],
                   "25 (c) the trainer", timeout=300)
    print("\n".join(ln for ln in out.splitlines()
                    if ln.startswith("25 (c)")))
    result.update(fleet_result(out, "25 (c) the trainer"))
    return result


def phase_fleet(torch) -> dict:
    phase("25. the node axis over a torch.distributed world: a world of one "
          "on the card, the per-rank receives of a four-rank ring, and with "
          "four cards the fleet's gossip, Mode B and train-on-trace")
    result = {"a": fleet_world_of_one(torch), "b": fleet_receives(torch)}
    if torch.cuda.device_count() >= FLEET_CARDS:
        result["c"] = fleet_four_cards(torch)
    else:
        print(f"25 (c) needs {FLEET_CARDS} cards, {torch.cuda.device_count()}"
              " visible: not run")
    return result


# ---------------------------------------------------------------------------
# The ranks of 25 (c) (run under torchrun: chip_smoke.py --fleet-rank ROLE)
# ---------------------------------------------------------------------------

def rank_print(msg: str) -> None:
    import torch.distributed as dist

    if dist.get_rank() == 0:
        print(msg, flush=True)


def rank_gossip(torch, fleet) -> dict:
    """The fleet's gossip_mix_tree and both compressed modes against
    plan_w @ X (and the one-device compressed mix) gathered on rank 0."""
    from repro_torch.core import compression as cp
    from repro_torch.core.gossip import gossip_mix_tree, plan_w, ring_plan
    from repro_torch.train import shardings as shr

    out = {}
    for n in (FLEET_CARDS, 2 * FLEET_CARDS):
        plan = ring_plan(("data",), (n,), 1)
        g = torch.Generator().manual_seed(n)
        x = torch.randn(n, 1 << 20, generator=g).cuda()
        res = (0.01 * torch.randn(n, 1 << 20, generator=g)).cuda()
        lo, hi = fleet.block(n)
        tree = {"a": x[lo:hi, :3000].reshape(-1, 30, 100),
                "b": x[lo:hi, 3000:]}
        mixed = shr.gather_nodes(gossip_mix_tree(tree, plan, fleet.group),
                                 fleet, n, dst=None)
        got = {}
        for mode in ("bf16", "int8"):
            cfg = cp.QuantConfig(mode=mode)
            m, e = cp.compressed_gossip_mix_array(x[lo:hi], res[lo:hi], plan,
                                                  cfg, fleet.group)
            got[mode] = shr.gather_nodes({"m": m, "e": e}, fleet, n,
                                         dst=None)
            got[mode]["one"] = cp.compressed_gossip_mix_array(
                x, res, plan, cfg)
        if fleet.index != 0:
            continue
        want = torch.as_tensor(plan_w(plan), dtype=torch.float64,
                               device="cuda") @ x.double()
        d_tree = max(err(mixed["a"].reshape(n, -1), want[:, :3000]),
                     err(mixed["b"], want[:, 3000:]))
        d_comp = {mode: max(err(v["m"], v["one"][0]), err(v["e"], v["one"][1]))
                  for mode, v in got.items()}
        rank_print(f"25 (c) {plan.name} on {n} nodes, {n // fleet.size} a "
                   f"card: gossip_mix_tree against plan_w @ X {d_tree:.3e}; "
                   f"compressed_gossip_mix_array (mixed, residual) against "
                   f"the one-card run: bf16 {d_comp['bf16']:.3e}, int8 "
                   f"{d_comp['int8']:.3e} (tol {TOL_FP32:g})")
        check(d_tree <= TOL_FP32 and max(d_comp.values()) <= TOL_FP32,
              f"25 (c) gossip on {n} nodes: tree {d_tree}, {d_comp}")
        out[str(n)] = {"tree": d_tree, **d_comp}
    return out


def rank_mode_b(torch, fleet) -> dict:
    """qwen2-vl-2b's Mode B at full depth, one node a card, ring-1 none and
    int8, AdamW, remat none, eager: ms a step, tokens/s, peak GiB per
    rank, P2P bytes a step against ``utils.collectives``' reckoning."""
    import gc
    import math

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import dpsgd
    from repro_torch.core.gossip import exchange, ring_plan
    from repro_torch.launch import dryrun
    from repro_torch.models import build
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import step as ts
    from repro_torch.utils.collectives import step_collectives

    full = get_config(POD_ARCH)
    plan = ring_plan(("data",), (FLEET_CARDS,), 1)
    api = build(full, "cuda")
    out = {"layers": full.n_layers, "remat": "none"}
    if fleet.index == 0:
        # the dry run's reckoning of one node's step, on the card's fake
        cell = dryrun.train_cell(full, _pod_run("dpsgd"), batch=POD_BATCH,
                                 seq_len=POD_SEQ, nodes=1,
                                 plan=ring_plan(("data",), (1,), 1))
        out["dry_peak_gib"] = cell["peak_bytes"] / 2**30
    rank_print(f"25 (c) {POD_ARCH} Mode B at full depth ({full.n_layers} "
               f"layers), {FLEET_CARDS} nodes one a card, {POD_BATCH} x "
               f"{POD_SEQ} tokens a node, AdamW, remat none, eager; the dry "
               f"run reckons one node's step at "
               f"{out.get('dry_peak_gib', 0):.3f} GiB")
    lo, hi = fleet.block(FLEET_CARDS)
    for comp in ("none", "int8"):
        run = _pod_run("dpsgd", compression=comp)
        step_fn = ts.make_train_step(api, run, plan, constant_lr(run.eta),
                                     group=fleet.group)
        state = ts.init_train_state(api, run, torch.Generator(
            device="cuda").manual_seed(1), n_nodes=hi - lo)
        # de-sync the nodes so the mix matters
        state["params"] = dpsgd._tree_map(
            lambda p: p * (1 + 0.01 * lo), state["params"])
        leaves = [(tuple(x.shape[1:]), str(x.dtype).removeprefix("torch."))
                  for x in dpsgd._leaves(state["params"])]
        reckoned = step_collectives(leaves, "dpsgd", plan=plan,
                                    compression=comp)["collectives"][
            "collective-permute"]["result_bytes"]
        torch.cuda.reset_peak_memory_stats()
        counters = fleet_counters()
        losses, times, sent = [], [], []
        for k in range(FLEET_WARM + FLEET_TIMED):
            batch = dpsgd._tree_map(lambda b: b[lo:hi], pod_batch(
                torch, full, k, FLEET_CARDS, POD_BATCH, POD_SEQ, "dpsgd"))
            if k == FLEET_WARM:
                for c in counters.values():
                    c.launches = 0
            dist.barrier()
            torch.cuda.synchronize()
            before = exchange.sent_bytes
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
            sent.append(exchange.sent_bytes - before)
            del batch, m
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = statistics.median(times[FLEET_WARM:])
        tokens = FLEET_CARDS * POD_BATCH * POD_SEQ
        peaks = [None] * fleet.size
        dist.all_gather_object(peaks, peak, group=fleet.group)
        sents = [None] * fleet.size
        dist.all_gather_object(sents, sent, group=fleet.group)
        rank_print(f"25 (c) {POD_ARCH} Mode B {plan.name} {comp}: losses "
                   f"{losses}; {ms:.2f} ms a step (median of "
                   f"{FLEET_TIMED} after {FLEET_WARM}, host clock to a loss "
                   f"read, steps {[round(t, 2) for t in times]}), "
                   f"{tokens / ms * 1e3:.0f} tokens/s; peak GiB per rank "
                   f"{[round(p, 3) for p in peaks]}; P2P bytes a step per "
                   f"rank {sorted(set(b for s in sents for b in s))} against "
                   f"utils.collectives' {reckoned}; rank 0's launches a "
                   f"step x{FLEET_TIMED}: {launches}")
        check(all(math.isfinite(v) for v in losses),
              f"25 (c) Mode B {comp}: losses {losses}")
        check(all(b == reckoned for s in sents for b in s),
              f"25 (c) Mode B {comp}: P2P bytes {sents} against {reckoned}")
        out[comp] = {"losses": losses, "ms": ms, "step_ms": times,
                     "tokens_per_s": tokens / ms * 1e3, "peak_gib": peaks,
                     "p2p_bytes": reckoned, "launches": launches}
        del state, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    return out


def rank_gather(torch, fleet) -> dict:
    """What ``train_loop`` does at a checkpoint and in the fault drill,
    at qwen2-vl-2b's full depth, one node a card, AdamW: the whole node
    axis of the state gathered into rank 0's host memory
    (``shardings.gather_nodes``, leaf by leaf) and scattered back: rank
    0's device peak over its own state against the dry run's reckoning
    (the largest leaf's whole axis), the round trip bit-equal."""
    import gc

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import dpsgd
    from repro_torch.models import build
    from repro_torch.train import shardings as shr
    from repro_torch.train import step as ts

    full = get_config(POD_ARCH)
    run = _pod_run("dpsgd")
    lo, hi = fleet.block(FLEET_CARDS)
    state = ts.init_train_state(build(full, "cuda"), run, torch.Generator(
        device="cuda").manual_seed(1), n_nodes=hi - lo)
    state["params"] = dpsgd._tree_map(lambda p: p * (1 + 0.01 * lo),
                                      state["params"])
    leaves = dpsgd._leaves(state)
    state_gib = sum(x.numel() * x.element_size() for x in leaves) / 2**30
    leaf_gib = max(x.numel() * x.element_size() for x in leaves) / 2**30
    reckoned = FLEET_CARDS * leaf_gib
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    whole = shr.gather_nodes(state, fleet, FLEET_CARDS)
    gather_s = time.perf_counter() - t0
    added = (torch.cuda.max_memory_allocated() - base) / 2**30
    on_host = whole is None or all(
        x.device.type == "cpu" for x in dpsgd._leaves(whole))
    own = whole is None or all(
        torch.equal((w[lo:hi] if x.dim() else w).to(x.device), x)
        for w, x in zip(dpsgd._leaves(whole), leaves))
    t0 = time.perf_counter()
    back = shr.scatter_nodes(whole, state, fleet, FLEET_CARDS)
    scatter_s = time.perf_counter() - t0
    del whole
    same = all(torch.equal(a, b) for a, b in
               zip(dpsgd._leaves(back), leaves))
    flags = [None] * fleet.size
    dist.all_gather_object(flags, (same, own, on_host, round(added, 3)),
                           group=fleet.group)
    rank_print(f"25 (c) {POD_ARCH} at full depth ({full.n_layers} layers), "
               f"AdamW, {state_gib:.3f} GiB of state a rank: the whole "
               f"{FLEET_CARDS}-node axis ({FLEET_CARDS * state_gib:.3f} GiB) "
               f"gathered into rank 0's host memory in {gather_s:.2f} s, "
               f"scattered back in {scatter_s:.2f} s; rank 0's device peak "
               f"over its state {added:.3f} GiB against the reckoning of "
               f"the largest leaf's whole axis, {reckoned:.3f} GiB; "
               f"(round trip bit-equal, rank 0's rows equal, on the host, "
               f"GiB added) per rank {flags}")
    check(all(f[0] and f[1] and f[2] for f in flags)
          and added <= reckoned + 0.01,
          f"25 (c) gather: {flags}, rank 0 added {added} GiB against "
          f"{reckoned}")
    del state, back, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return {"state_gib": state_gib, "added_gib": added,
            "reckoned_gib": reckoned, "gather_s": gather_s,
            "scatter_s": scatter_s}


def rank_family(torch, fleet_mesh) -> dict:
    """stablelm-3b's compressed_int8 family at 1 layer of its published
    widths: 6 nodes over a fleet of 3, 4 rounds, eager: losses, ms a
    round, peak GiB and launches per rank, and the call's trace."""
    import dataclasses
    import gc
    import math

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.sim import batch as tb
    from repro_torch.sim import get_scenario, precompute_traces
    from repro_torch.utils import profile

    mcfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    ad = tb.transformer_adapter(mcfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                eval_batch=TRAIN_EVAL_BATCH, device="cuda")
    cfg = get_scenario("compressed_int8", model_bits=ad.model_bits,
                       model_shapes=ad.param_shapes,
                       eval_every_rounds=TRAIN_ROUNDS)
    traces = precompute_traces([cfg], TRAIN_ROUNDS)

    def family(rounds: int = TRAIN_ROUNDS):
        return tb.train_model_on_traces(
            ad, [cfg], rounds, trace_batch=traces if rounds == TRAIN_ROUNDS
            else precompute_traces([cfg], rounds), mesh=fleet_mesh,
            device="cuda")[1]

    family(1)                           # warm: cuBLAS plans, NCCL's rings
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    res, launches = launched(torch, family)
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = {"losses": res["losses"][0].tolist(),
           "ms_a_round": wall_ms / TRAIN_ROUNDS, "nodes": cfg.n_nodes,
           "ranks": dist.get_world_size(),
           "launches": {k: v for k, v in launches.items() if v}}
    traced = profile.trace(family)
    out["busy_ms"] = traced["busy_ms"]
    out["idle"] = 1.0 - traced["busy_ms"] / wall_ms
    out["top"] = [(n[:60], round(ms, 3), c)
                  for n, ms, c in traced["top"][:8]]
    for key, value in (("peak_gib", peak), ("launches_by_rank",
                                            out["launches"])):
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, value)
        out[key] = got
    rank_print(f"25 (c) {TRAIN_ARCH} compressed_int8 (payload "
               f"{cfg.payload.mode}, {cfg.payload.granularity}) at "
               f"{TRAIN_LAYERS} layer of its published widths: "
               f"{cfg.n_nodes} nodes over a fleet of {dist.get_world_size()}"
               f", batch {TRAIN_BATCH} x {TRAIN_SEQ} a node, {TRAIN_ROUNDS} "
               f"rounds, eager: losses {out['losses']}; "
               f"{out['ms_a_round']:.2f} ms a round (the call's wall over "
               f"its rounds, its set-up, the final gathers and the "
               f"evaluation included); peak GiB per rank "
               f"{[round(p, 3) for p in out['peak_gib']]}; launches per "
               f"rank {out['launches_by_rank']}; device busy "
               f"{out['busy_ms']:.2f} ms of the call's {wall_ms:.2f} (idle "
               f"{out['idle']:.4f}), the largest: "
               + "; ".join(f"{n} {ms} ms x{c}" for n, ms, c in out["top"]))
    check(all(math.isfinite(v) for v in out["losses"]),
          f"25 (c) family: losses {out['losses']}")
    return out


def rank_capture(torch, fleet) -> dict:
    """The fleet's Mode B step (P2P and the loss's all_gather inside)
    captured as a CUDA graph, as ``train_loop`` runs it on the card: the
    smoke widths' replay must be bit-equal to the eager step on every
    rank."""
    import math

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import dpsgd
    from repro_torch.core.gossip import ring_plan
    from repro_torch.graphs import GraphedStep
    from repro_torch.models import build
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import step as ts

    smoke = reduce_for_smoke(get_config(POD_ARCH))
    plan = ring_plan(("data",), (FLEET_CARDS,), 1)
    run = _pod_run("dpsgd", compression="int8")
    api = build(smoke, "cuda")
    step_fn = ts.make_train_step(api, run, plan, constant_lr(run.eta),
                                 group=fleet.group)
    lo, hi = fleet.block(FLEET_CARDS)
    state = ts.init_train_state(api, run, torch.Generator(
        device="cuda").manual_seed(1), n_nodes=hi - lo)
    batch = dpsgd._tree_map(lambda b: b[lo:hi], pod_batch(
        torch, smoke, 0, FLEET_CARDS, POD_LOCK_BATCH, POD_LOCK_SEQ, "dpsgd"))
    eager, m_e = step_fn(state, batch)
    got, m_g = GraphedStep(step_fn)(state, batch)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(
        dpsgd._leaves(got), dpsgd._leaves(eager))) and torch.equal(
        m_g["loss"], m_e["loss"])
    flags = [None] * fleet.size
    dist.all_gather_object(flags, same, group=fleet.group)
    rank_print(f"25 (c) graph capture of the fleet's Mode B step (smoke "
               f"widths, {plan.name} int8, P2P inside the capture): replay "
               f"bit-equal to eager (state and loss) on every rank: {flags}; "
               f"the eager step's loss {float(m_e['loss']):.4f}")
    check(all(flags) and math.isfinite(float(m_e["loss"])),
          f"25 (c) capture: replay bit-equal per rank {flags}, eager loss "
          f"{float(m_e['loss'])}")
    return {"captured": all(flags), "ranks": flags}


def rank_trainer(torch, fleet) -> dict:
    """``launch.train.train_loop`` over the fleet at the smoke widths,
    graphed as on the card by default, ring-1 int8: four steps straight,
    then two with a checkpoint (rank 0 gathers the node axis to its host
    and writes it) and a resume to four (rank 0 scatters it), steps 3-4
    against the straight run's; and the fault drill (node 2 dies at step
    3: gathered, reshaped, replanned, scattered)."""
    import math
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch import train as lt

    smoke = reduce_for_smoke(get_config(POD_ARCH))
    run = _pod_run("dpsgd", compression="int8")
    kw = dict(nodes=FLEET_CARDS, tp=1, batch_per_node=POD_LOCK_BATCH,
              seq_len=POD_LOCK_SEQ, log_every=1, device="cuda")
    where = [tempfile.mkdtemp() if fleet.index == 0 else None]
    dist.broadcast_object_list(where, src=fleet.global_rank(0),
                               group=fleet.group)
    ck = where[0]
    straight = lt.train_loop(smoke, run, steps=4, ckpt_dir=None, **kw)
    lt.train_loop(smoke, run, steps=2, ckpt_dir=ck, ckpt_every=2, **kw)
    resumed = lt.train_loop(smoke, run, steps=4, ckpt_dir=ck, resume=True,
                            **kw)
    drill = lt.train_loop(smoke, run, steps=5, ckpt_dir=None, fail_at=3,
                          fail_node=2, **kw)
    dist.barrier()
    if fleet.index == 0:
        shutil.rmtree(ck, ignore_errors=True)
    got = [r["loss"] for r in resumed["log"]]
    want = [r["loss"] for r in straight["log"][2:]]
    d = max(abs(x - y) for x, y in zip(got, want))
    losses = [r["loss"] for r in drill["log"]]
    rank_print(f"25 (c) train_loop over {fleet.size} ranks (smoke widths, "
               f"{FLEET_CARDS} nodes one a card, int8, graphed): a "
               f"checkpoint at step 2 and resume=True, steps 3-4 losses {got}"
               f" against the uninterrupted {want}: "
               f"{'bit-equal' if got == want else f'max|diff| {d:.3e}'}; "
               f"the fault drill (node 2 dies at step 3) losses {losses}")
    check([r["step"] for r in resumed["log"]] == [3, 4] and d <= LOCK_TOL,
          f"25 (c) resume over the fleet: {resumed['log']} against "
          f"{straight['log']}")
    check(len(losses) == 5 and all(math.isfinite(v) for v in losses),
          f"25 (c) fault drill over the fleet: {drill['log']}")
    return {"resume_bit_equal": got == want, "resume_diff": d,
            "drill_losses": losses}


# ---------------------------------------------------------------------------
# 26. Tensor parallelism over the 'model' mesh axis
# ---------------------------------------------------------------------------

TP_CARDS = 4
TP_NODES = 2                        # (b) qwen2-vl-2b Mode B: 2 nodes x TP 2
TP_A_ARCH, TP_A_SIZE = "gemma3-12b", 4   # (b) Mode A, one node over 4 cards
TP_A_BATCH, TP_A_SEQ = 4, 512
TP_WARM, TP_TIMED = 1, 3
TP_FAMILY_ROUNDS = 3
# (b) the family and the twin against one card alone: losses within the
# smoke's parity bar (a shard's own int8 blocks drifted 3.1e-4 by round 3);
# parameters within a few int8 steps of a 2048-lane block (~6e-4 at the
# smoke's widths): a value at a level's edge may round the other way
# when a GEMM of other widths moves it by an ulp
TP_FAMILY_LOSS_TOL, TP_FAMILY_PARAM_TOL = 1e-5, 2e-3
TP_LOSS_TOL = 1e-4                  # the twin's free-running losses
TP_CALL_S = 900
TP_CAPTURE_S = 300                   # the capture world's time limit
# (a) flash at the local head shapes this slice launches:
# (B, S, T, Hq, Hkv, D, causal, window)
TP_FLASH = {
    "gemma3-12b at tp 4, local": (TP_A_BATCH, TP_A_SEQ, TP_A_SEQ, 4, 2, 256,
                                  True, 1024),
    "gemma3-12b at tp 4, global": (TP_A_BATCH, TP_A_SEQ, TP_A_SEQ, 4, 2,
                                   256, True, 0),
    "qwen2-vl-2b at tp 2": (POD_BATCH, POD_SEQ, POD_SEQ, 6, 1, 128, True, 0),
}


def tp_collectives() -> dict:
    """The regions' collectives so far (``models.tp.COLLECTIVES``)."""
    from repro_torch.models import tp

    return {k: tuple(v) for k, v in tp.COLLECTIVES.items()}


def tp_world_of_one(torch) -> dict:
    """26 (a): a world of one rank (NCCL) on a (1, 1) mesh runs every step
    through the tensor-parallel code with groups of one: Mode B none and
    int8, Mode A, and the compressed_int8 family, each bit-equal to the
    one-device run with the same launches."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import dpsgd
    from repro_torch.core.gossip import ring_plan
    from repro_torch.launch import mesh as lm
    from repro_torch.launch.train import model_specs
    from repro_torch.models import build, tp
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.sim import batch as tb
    from repro_torch.sim import get_scenario, precompute_traces
    from repro_torch.train import shardings as shr
    from repro_torch.train import step as ts

    smoke = reduce_for_smoke(get_config(POD_ARCH))
    plan = ring_plan(("data",), (POD_NODES,), 1)
    ad = tb.transformer_adapter(TRAIN_ARCH, batch=TRAIN_BATCH,
                                seq_len=LOCK_TRAIN_SEQ, device="cuda")
    cfg = get_scenario("compressed_int8", model_bits=ad.model_bits,
                       model_shapes=ad.param_shapes,
                       eval_every_rounds=LOCK_TRAIN_ROUNDS)
    traces = precompute_traces([cfg], LOCK_TRAIN_ROUNDS)
    cases = (("Mode B none", "dpsgd", "none"), ("Mode B int8", "dpsgd", "int8"),
             ("Mode A", "allreduce", "none"))

    def runs(mesh) -> dict:
        model = tp.model_of(mesh)
        fleet = shr.fleet_of(mesh)
        out = {}
        for label, mode, comp in cases:
            run = _pod_run(mode, compression=comp)
            kw = {} if mesh is None else dict(
                group=fleet.group, model=model,
                specs=model_specs(smoke, model.size))
            step = ts.make_train_step(build(smoke, "cuda", model=kw.get(
                "model")), run, plan if mode == "dpsgd" else None,
                constant_lr(run.eta), **kw)
            state = ts.init_train_state(
                build(smoke, "cuda"), run,
                torch.Generator(device="cuda").manual_seed(26),
                n_nodes=POD_NODES)
            batch = pod_batch(torch, smoke, 0, POD_NODES, POD_LOCK_BATCH,
                              POD_LOCK_SEQ, mode)
            (new, m), n = launched(torch, lambda: step(state, batch))
            out[label] = ([x.clone() for x in dpsgd._leaves(new)],
                          float(m["loss"]), n)
        tb._STEPS.clear()        # capture the family's graph afresh
        out["family compressed_int8"] = launched(
            torch, lambda: tb.train_model_on_traces(
                ad, [cfg], LOCK_TRAIN_ROUNDS, trace_batch=traces, mesh=mesh,
                device="cuda")[1])
        return out

    one = runs(None)
    with tempfile.TemporaryDirectory() as d:
        lm.init_world("cuda", init_method=f"file://{d}/store", rank=0,
                      world_size=1)
        try:
            mesh = lm.make_fleet_mesh(1, 1)
            before = tp_collectives()
            world = runs(mesh)
            issued = tp_collectives() != before
            print(f"26 (a) a world of {dist.get_world_size()} rank on a "
                  f"(fleet, model) = {tuple(mesh.mesh.shape)} mesh: every "
                  f"step through the tensor-parallel code, groups of one "
                  f"({'some' if issued else 'no'} region collective issued)")
        finally:
            dist.destroy_process_group()
    tb._STEPS.clear()
    check(not issued, "26 (a): a model axis of one issued a collective")
    result = {}
    for label, _, _ in cases:
        (a, la, na), (b, lb, nb) = one[label], world[label]
        same = la == lb and all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"26 (a) {POD_ARCH} smoke {label}: loss {lb:.6f}, the new "
              f"state {'bit-equal to' if same else 'UNLIKE'} the one-device "
              f"step's; launches {nb} against {na}")
        check(same and na == nb, f"26 (a) {label}: {lb} {nb} against "
              f"{la} {na}")
        result[label] = nb
    (a, la), (b, lb) = one["family compressed_int8"], \
        world["family compressed_int8"]
    same = np.array_equal(a["losses"], b["losses"]) and all(
        torch.equal(x, y) for x, y in zip(dpsgd._leaves(a["final_params"]),
                                          dpsgd._leaves(b["final_params"])))
    print(f"26 (a) train_model_on_traces(mesh=(1, 1)) on compressed_int8, "
          f"{TRAIN_ARCH}'s smoke config: losses {b['losses'][0].tolist()}, "
          f"{'bit-equal to' if same else 'UNLIKE'} the one-device family; "
          f"launches {lb} against {la}")
    check(same and la == lb, f"26 (a) family: launches {lb} against {la}")
    result["family compressed_int8"] = lb
    return result


def tp_flash(torch, shapes: dict = TP_FLASH, label: str = "26 (a)") -> dict:
    """26 (a) (and 27 (a) on its ``shapes``): flash forward (with lse) and
    backward at the local head shapes tensor parallelism gives them,
    against their plain versions under the phase 3e bars, with times
    beside the bound and SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(26)
    bf16 = torch.bfloat16
    out = {}
    for what, (b, s, t, hq, hkv, d, causal, window) in shapes.items():
        q, do = (torch.randn((b, s, hq, d), generator=gen, device="cuda")
                 .to(bf16) for _ in range(2))
        k, v = (torch.randn((b, t, hkv, d), generator=gen, device="cuda")
                .to(bf16) for _ in range(2))
        o, lse = fa._forward(q, k, v, causal, window, True)
        o_p, lse_p = fa.flash_attention_plain(q, k, v, causal=causal,
                                              window=window, return_lse=True)
        e_o, e_l = err(o, o_p), err(lse, lse_p)
        re = row_err(o, o_p)
        check(e_o <= TOL_BF16 and re <= TOL_FLASH_ROW and e_l <= TOL_LSE,
              f"{label} flash forward {what}: out {e_o}, rows {re}, lse {e_l}")
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     window=window)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                            causal=causal, window=window,
                                            acc_dtype=torch.float64)
        e_b, excess = 0.0, 0
        for g, w_ in zip(got, want):
            e_b = max(e_b, err(g, w_))
            # GQA sums a kv head's q heads into dk, dv: held within the bar
            # or one bf16 ulp, whichever is larger (phase 3e's rule)
            excess += bf16_ulp_excess(torch, g, w_, TOL_BF16)
        check(excess == 0, f"{label} flash backward {what}: {excess} "
              f"elements beyond max({TOL_BF16}, one bf16 ulp)")
        del got, want, o_p, lse_p
        fwd = lambda: fa._forward(q, k, v, causal, window, True)  # noqa
        bwd = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, o, lse, do, causal=causal, window=window)
        qq, kk, vv = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        mask = None
        if window:
            qpos = torch.arange(s, device="cuda")[:, None]
            kpos = torch.arange(t, device="cuda")[None, :]
            mask = (kpos <= qpos) & (qpos - kpos < window)

        def sdpa():
            return F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=hq != hkv)
        lib_out = sdpa()
        dot = do.transpose(1, 2)
        f_bytes, f_flops = cost.flash_gqa_cost(b, s, t, hq, hkv, d, causal,
                                                window, 2, lse=True)
        b_bytes, b_flops = cost.bwd_cost(b, s, t, hq, hkv, d, causal,
                                         window, 2)
        row = {
            "shape": f"q ({b},{s},{hq},{d}) k, v ({b},{t},{hkv},{d}) bf16, "
                     f"{'causal' if causal else 'non-causal'}, window "
                     f"{window}",
            "fwd_max_abs_err": e_o, "bwd_max_abs_err": e_b,
            "fwd_ms": time_ms(torch, fwd, reps=10, rounds=3, warmup=2),
            "bwd_ms": time_ms(torch, bwd, reps=5, rounds=3, warmup=1),
            "fwd_plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=causal, window=window, return_lse=True),
                reps=1, rounds=3, warmup=1),
            "bwd_plain_ms": time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal=causal, window=window),
                reps=1, rounds=3, warmup=1),
            "fwd_library_ms": time_ms(torch, sdpa, reps=10, rounds=3,
                                      warmup=2),
            "bwd_library_ms": time_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qq, kk, vv), dot, retain_graph=True), reps=5,
                rounds=3, warmup=1)}
        row["fwd_bound_ms"], row["fwd_bound_by"] = cost.bound(
            f_bytes, f_flops, cost.BF16_FLOPS)
        row["bwd_bound_ms"], row["bwd_bound_by"] = cost.bound(
            b_bytes, b_flops, cost.BF16_FLOPS)
        print(f"{label} flash at {what}: {row['shape']}: forward max|err| "
              f"{e_o:.3e} (rows {re:.3e}, lse {e_l:.3e}), backward "
              f"{e_b:.3e} (0 past max({TOL_BF16:g}, 1 ulp)); forward "
              f"{row['fwd_ms']:.4f} ms (plain {row['fwd_plain_ms']:.4f}, "
              f"SDPA {row['fwd_library_ms']:.4f}, bound "
              f"{row['fwd_bound_ms']:.4f} {row['fwd_bound_by']}), backward "
              f"{row['bwd_ms']:.4f} ms (plain {row['bwd_plain_ms']:.4f}, "
              f"SDPA {row['bwd_library_ms']:.4f}, bound "
              f"{row['bwd_bound_ms']:.4f} {row['bwd_bound_by']})")
        out[what] = row
        del q, k, v, o, lse, do, qq, kk, vv, lib_out
    torch.cuda.empty_cache()
    return out


def tp_four_cards(torch) -> dict:
    """26 (b): the (fleet, model) worlds on four cards, one a rank."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    script = str(ROOT / Path(__file__).name)
    result = {}
    out = torchrun(TP_CARDS, ["-m", "repro_torch.sim.real_model_smoke",
                              "--json", "--device", "cuda"],
                   "26 (b) real_model_smoke", timeout=TP_CALL_S)
    report = json.loads([ln for ln in out.splitlines()
                         if ln.startswith("{")][-1])
    print(f"26 (b) real_model_smoke at its defaults (fleet "
          f"{report['mesh']['fleet']} x model {report['mesh']['model']}): ok "
          f"{report['ok']}, {report['devices_spanned']} cards spanned, "
          f"parity {report['parity']}")
    check(report["ok"] and report["devices_spanned"] == TP_CARDS
          and report["mesh"] == {"fleet": 2, "model": 2},
          f"26 (b) real_model_smoke: {report}")
    result["real_model_smoke"] = report
    out = torchrun(TP_CARDS, [script, "--fleet-rank", "tp"],
                   "26 (b) tensor parallelism", timeout=TP_CALL_S)
    print("\n".join(ln for ln in out.splitlines()
                    if ln.startswith("26 (b)")))
    result.update(fleet_result(out, "26 (b) tensor parallelism"))
    # last, in a world of its own with a short limit: a tensor-parallel
    # step captured as a CUDA graph (a sharded family's all-gathers hung
    # under capture on four H100s)
    out = torchrun(TP_CARDS, [script, "--fleet-rank", "tp-capture"],
                   "26 (b) capture of a tensor-parallel step",
                   timeout=TP_CAPTURE_S)
    print("\n".join(ln for ln in out.splitlines()
                    if ln.startswith("26 (b)")))
    result["capture"] = fleet_result(out, "26 (b) capture")
    return result


def phase_tp(torch) -> dict:
    phase("26. tensor parallelism over the 'model' mesh axis: a (1, 1) "
          "world through the tensor-parallel code, flash at the local head "
          "shapes, and with four cards the (fleet, model) worlds")
    result = {"a": tp_world_of_one(torch), "flash": tp_flash(torch)}
    if torch.cuda.device_count() >= TP_CARDS:
        result["b"] = tp_four_cards(torch)
    else:
        print(f"26 (b) needs {TP_CARDS} cards, {torch.cuda.device_count()} "
              "visible: not run")
    return result


# ---------------------------------------------------------------------------
# The ranks of 26 (b) (chip_smoke.py --fleet-rank tp, four ranks)
# ---------------------------------------------------------------------------

def rank_tp_twin_and_trainer(torch) -> dict:
    """The pod_gossip_train twin at 2 x 2, and ``launch.train.train_loop
    --nodes 2 --tp 2`` at the smoke widths: straight, then a checkpoint
    at step 2 and a resume to 4 (steps 3-4 against the straight run's,
    bit-equal on every rank), and the fault drill at step 3."""
    import math
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.examples import pod_gossip_train
    from repro_torch.launch import train as lt

    twin = pod_gossip_train.run(nodes=TP_NODES, tp_size=2, steps=3,
                                device="cuda", log=lambda *_: None)
    # the same twin on this rank's card alone: seed, plan and tokens
    alone = pod_gossip_train.run(nodes=TP_NODES, tp_size=1, steps=3,
                                 device="cuda", log=lambda *_: None,
                                 alone=True)
    twin_diff = max(abs(a - b) for a, b in zip(twin["losses"],
                                               alone["losses"]))
    twin_flags = [None] * dist.get_world_size()
    dist.all_gather_object(twin_flags, twin_diff)
    smoke = reduce_for_smoke(get_config(POD_ARCH))
    run = _pod_run("dpsgd", compression="int8")
    kw = dict(nodes=TP_NODES, tp=2, batch_per_node=POD_LOCK_BATCH,
              seq_len=POD_LOCK_SEQ, log_every=1, device="cuda")
    where = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(where, src=0)
    ck = where[0]
    straight = lt.train_loop(smoke, run, steps=4, ckpt_dir=None, **kw)
    lt.train_loop(smoke, run, steps=2, ckpt_dir=ck, ckpt_every=2, **kw)
    resumed = lt.train_loop(smoke, run, steps=4, ckpt_dir=ck, resume=True,
                            **kw)
    drill = lt.train_loop(smoke, run, steps=5, ckpt_dir=None, fail_at=3,
                          fail_node=1, **kw)
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(ck, ignore_errors=True)
    got = [r["loss"] for r in resumed["log"]]
    want = [r["loss"] for r in straight["log"][2:]]
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, got == want)
    losses = [r["loss"] for r in drill["log"]]
    rank_print(f"26 (b) pod_gossip_train twin ({TP_NODES} nodes x TP 2, "
               f"{twin['plan']}, int8): losses {twin['losses']}, one card "
               f"alone {alone['losses']}: the largest difference per rank "
               f"{twin_flags} (bar {TP_LOSS_TOL}); a step on rank 0: P2P "
               f"bytes {twin['p2p_bytes']}, launches {twin['launches']}")
    rank_print(f"26 (b) train_loop --nodes {TP_NODES} --tp 2 (smoke widths, "
               f"int8, graphed): a checkpoint at step 2 and resume=True, steps "
               f"3-4 losses {got} against the uninterrupted {want}: "
               f"bit-equal per rank {flags}; the fault drill (node 1 dies at "
               f"step 3) losses {losses}")
    check(all(flags) and [r["step"] for r in resumed["log"]] == [3, 4],
          f"26 (b) resume: {flags} {resumed['log']} {straight['log']}")
    check(len(losses) == 5 and all(math.isfinite(v) for v in losses)
          and all(math.isfinite(v) for v in twin["losses"])
          and all(d <= TP_LOSS_TOL for d in twin_flags),
          f"26 (b) drill {drill['log']}, twin {twin['losses']} against "
          f"{alone['losses']} alone")
    return {"twin": {k: twin[k] for k in ("losses", "p2p_bytes",
                                          "launches")},
            "twin_vs_alone": twin_flags,
            "resume_bit_equal": all(flags), "drill_losses": losses}


def rank_tp_family(torch, mesh) -> dict:
    """stablelm-3b's smoke config on compressed_int8 over (fleet 2, model
    2), eager: the int8 send and the q8 receive on the whole leaves
    gathered over the model axis; held on every rank against the same
    family on its card alone (same traces, seed and batches)."""
    import math

    import torch.distributed as dist

    from repro_torch.core.dpsgd import _leaves
    from repro_torch.sim import batch as tb
    from repro_torch.sim import get_scenario, precompute_traces

    ad = tb.transformer_adapter(TRAIN_ARCH, batch=TRAIN_BATCH,
                                seq_len=LOCK_TRAIN_SEQ, device="cuda")
    cfg = get_scenario("compressed_int8", model_bits=ad.model_bits,
                       model_shapes=ad.param_shapes,
                       eval_every_rounds=TP_FAMILY_ROUNDS)
    traces = precompute_traces([cfg], TP_FAMILY_ROUNDS)
    (_, res), launches = launched(torch, lambda: tb.train_model_on_traces(
        ad, [cfg], TP_FAMILY_ROUNDS, trace_batch=traces, mesh=mesh,
        device="cuda"))
    _, one = tb.train_model_on_traces(ad, [cfg], TP_FAMILY_ROUNDS,
                                      trace_batch=traces, device="cuda")
    losses = res["losses"][0].tolist()
    diff = {"losses": float(abs(res["losses"][0]
                                - one["losses"][0]).max()),
            "params": max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(_leaves(res["final_params"][0]),
                                          _leaves(one["final_params"][0])))}
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, ({k: v for k, v in launches.items() if v},
                                 diff))
    rank_print(f"26 (b) {TRAIN_ARCH} smoke on compressed_int8 over (fleet "
               f"2, model 2), {cfg.n_nodes} nodes, {TP_FAMILY_ROUNDS} "
               f"rounds, eager: losses {losses}, one card alone "
               f"{one['losses'][0].tolist()}; per rank the launches and the "
               f"largest differences from the card alone (bars: losses "
               f"{TP_FAMILY_LOSS_TOL}, parameters {TP_FAMILY_PARAM_TOL}) "
               f"{got}")
    check(all(math.isfinite(v) for v in losses)
          and all(g.get("quantize_int8_ef") == TP_FAMILY_ROUNDS
                  and g.get("gossip_mix_q8") == TP_FAMILY_ROUNDS
                  and d["losses"] <= TP_FAMILY_LOSS_TOL
                  and d["params"] <= TP_FAMILY_PARAM_TOL
                  for g, d in got),
          f"26 (b) family: {losses} {got}")
    return {"losses": losses, "launches_by_rank": [g for g, _ in got],
            "vs_alone": [d for _, d in got]}


def rank_tp_steps(torch, what: str, cfg, run, plan, mesh, nodes: int,
                  batch: int, seq: int, tokens: int,
                  graphed: bool = False, donate: bool = False,
                  label: str = "26 (b)", replicated: bool = False) -> dict:
    """Warm-up and timed steps of ``make_train_step`` over ``mesh``:
    losses, ms a step (host clock to a loss read), tokens/s, peak GiB and
    launches per rank, P2P bytes against the reckoning for the rank's
    shard, the regions' all-reduce and all-gather bytes a step, and one
    traced step's busy ms and idle share. ``donate``: the step consumes
    its state (``make_train_step``'s ``donate``, as ``launch.train``'s
    eager step). ``replicated``: after the last step every leaf the specs
    leave whole must be bit-equal across the model group's ranks."""
    import math

    import torch.distributed as dist

    from repro_torch.core import dpsgd
    from repro_torch.core.gossip import exchange
    from repro_torch.launch.train import model_specs, shard_cast
    from repro_torch.models import build, tp
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import shardings as shr
    from repro_torch.train import step as ts
    from repro_torch.utils import profile
    from repro_torch.utils.collectives import step_collectives

    model, fleet = tp.model_of(mesh), shr.fleet_of(mesh)
    mode_b = run.mode == "dpsgd"
    lo, hi = fleet.block(nodes) if mode_b else (0, 1)
    specs = model_specs(cfg, model.size)
    step_fn = ts.make_train_step(build(cfg, "cuda", model=model), run, plan,
                                 constant_lr(run.eta), group=fleet.group,
                                 model=model, specs=specs, donate=donate)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = ts.init_train_state(
        build(cfg, "cuda", model=model), run,
        torch.Generator(device="cuda").manual_seed(1),
        n_nodes=hi - lo, cast=shard_cast(cfg, model))
    init_s = time.perf_counter() - t0
    if mode_b:      # de-sync the nodes so the mix matters
        state["params"] = dpsgd._tree_map(
            lambda p: p * (1 + 0.01 * lo), state["params"])
    state_gib = sum(x.numel() * x.element_size()
                    for x in dpsgd._leaves(state)) / 2**30
    reckoned = None
    if mode_b:
        leaves = [(tuple(x.shape[1:]), str(x.dtype).removeprefix("torch."))
                  for x in dpsgd._leaves(state["params"])]
        reckoned = step_collectives(leaves, "dpsgd", plan=plan,
                                    compression=run.compression)[
            "collectives"]["collective-permute"]["result_bytes"]
    counters = {**fleet_counters(), **train_counters()}
    losses, times, sent, coll = [], [], [], []
    for k in range(TP_WARM + TP_TIMED):
        b = pod_batch(torch, cfg, k, nodes, batch, seq, run.mode)
        if mode_b:
            b = dpsgd._tree_map(lambda x: x[lo:hi], b)
        if k == TP_WARM:
            for c in counters.values():
                c.launches = 0
        dist.barrier()
        torch.cuda.synchronize()
        before, c0 = exchange.sent_bytes, tp_collectives()
        t1 = time.perf_counter()
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t1) * 1e3)
        sent.append(exchange.sent_bytes - before)
        c1 = tp_collectives()
        coll.append({kk: (c1[kk][0] - c0[kk][0], c1[kk][1] - c0[kk][1])
                     for kk in c1})
        del b, m
    launches = {kk: c.launches for kk, c in counters.items() if c.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = statistics.median(times[TP_WARM:])
    b = pod_batch(torch, cfg, 0, nodes, batch, seq, run.mode)
    if mode_b:
        b = dpsgd._tree_map(lambda x: x[lo:hi], b)
    out_state = [state]

    def one():
        out_state[0], mm = step_fn(out_state[0], b)
        float(mm["loss"])
    dist.barrier()
    traced = profile.trace(one)
    wall = traced.get("wall_ms") or ms
    idle = 1.0 - traced["busy_ms"] / wall if wall else None
    graph = None
    if graphed:     # the same steps replayed as a CUDA graph, in turn
        from repro_torch.graphs import GraphedStep

        g_step, g_times, g_losses = GraphedStep(step_fn), [], []
        for k in range(TP_WARM + TP_TIMED):
            bk = pod_batch(torch, cfg, k, nodes, batch, seq, run.mode)
            if mode_b:
                bk = dpsgd._tree_map(lambda x: x[lo:hi], bk)
            dist.barrier()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            replay = g_step.stage(out_state[0], bk)
            out_state[0] = None
            out_state[0], mm = replay()
            g_losses.append(float(mm["loss"]))
            g_times.append((time.perf_counter() - t1) * 1e3)
            del bk, mm, replay
        g_ms = statistics.median(g_times[TP_WARM:])
        graph = {"ms": g_ms, "tokens_s": tokens / g_ms * 1e3,
                 "steps_ms": g_times, "losses": g_losses}
        del g_step
        rank_print(f"{label} {what}, as a CUDA graph: {g_ms:.2f} ms a step "
                   f"(median of {TP_TIMED} after {TP_WARM}, the first "
                   f"capturing; steps {[round(t, 2) for t in g_times]}), "
                   f"{tokens / g_ms * 1e3:.0f} tokens/s; losses {g_losses}")
        check(all(math.isfinite(v) for v in g_losses),
              f"{label} {what} graphed: {g_losses}")
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, round(peak, 3))
    sents = [None] * dist.get_world_size()
    dist.all_gather_object(sents, sent)
    rank_print(f"{label} {what}, eager: losses {losses}; {ms:.2f} ms a step "
               f"(median "
               f"of {TP_TIMED} after {TP_WARM}, host clock to a loss read, "
               f"steps {[round(t, 2) for t in times]}), "
               f"{tokens / ms * 1e3:.0f} tokens/s; state {state_gib:.3f} GiB "
               f"a rank (drawn and sharded in {init_s:.1f} s); peak GiB per "
               f"rank {peaks}; P2P bytes a step per rank "
               f"{sorted(set(x for s in sents for x in s))} against "
               f"utils.collectives' {reckoned} for the shard; the regions' "
               f"collectives a step (calls, bytes) {coll[-1]}; rank 0's "
               f"launches x{TP_TIMED}: {launches}; a traced step: busy "
               f"{traced['busy_ms']:.2f} ms of {wall:.2f} (idle "
               f"{idle:.4f}), the largest: " + "; ".join(
                   f"{n[:40]} {t_:.3f} ms x{c}"
                   for n, t_, c in traced["top"][:6]))
    check(all(math.isfinite(v) for v in losses), f"{label} {what}: {losses}")
    if mode_b:
        check(all(x == reckoned for s in sents for x in s),
              f"{label} {what}: P2P bytes {sents} against {reckoned}")
    same = None
    if replicated:
        same = replicated_equal(torch, out_state[0]["params"], specs, model)
        rank_print(f"{label} {what}: the leaves the specs leave whole "
                   f"bit-equal across the model ranks after the steps, per "
                   f"rank: {same}")
        check(all(same), f"{label} {what}: replicated leaves {same}")
    del state, out_state, step_fn
    return {"losses": losses, "ms": ms, "tokens_s": tokens / ms * 1e3,
            "steps_ms": times, "state_gib": state_gib, "peak_gib": peaks,
            "p2p_bytes": sents[0][-1] if mode_b else 0,
            "p2p_reckoned": reckoned, "collectives": coll[-1],
            "launches": launches, "busy_ms": traced["busy_ms"],
            "idle": idle, "init_s": init_s, "graphed": graph,
            "replicated_equal": same,
            "top": [(n[:60], round(t_, 3), c)
                    for n, t_, c in traced["top"][:8]]}


def rank_tp_allreduce(torch, mesh, shape: tuple) -> dict:
    """The regions' all-reduce alone: a ``shape`` bf16 tensor over
    ``mesh``'s model group, back to back after a barrier (CUDA events):
    its ms and bus rate, against which a step's all-reduce time is
    transfer or waiting for the slowest rank."""
    import torch.distributed as dist

    from repro_torch.models import tp

    model = tp.model_of(mesh)
    x = torch.randn(shape, device="cuda").to(torch.bfloat16)
    dist.barrier()
    ms = time_ms(torch, lambda: dist.all_reduce(x, group=model.group),
                 reps=20, rounds=3, warmup=3)
    nbytes = x.numel() * x.element_size()
    # a ring all-reduce moves 2 (n - 1) / n of the tensor over each link
    bus = 2 * (model.size - 1) / model.size * nbytes / ms / 1e6
    rank_print(f"26 (b) an all-reduce of {tuple(shape)} bf16 "
               f"({nbytes / 1e6:.2f} MB) over a model group of "
               f"{model.size}, alone: {ms:.4f} ms, {bus:.1f} GB/s bus")
    return {"shape": list(shape), "ms": ms, "bus_gb_s": bus}


def rank_tp_capture(torch) -> dict:
    """qwen2-vl-2b's smoke Mode B step (int8, 2 nodes x TP 2) captured as
    a CUDA graph (``graphs.GraphedStep``: the regions' all-reduces, the
    row max's, the fleet's P2P inside): the replay must be bit-equal to
    the eager step on every rank."""
    import math

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import dpsgd
    from repro_torch.core.gossip import ring_plan
    from repro_torch.graphs import GraphedStep
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.launch.train import model_specs, shard_cast
    from repro_torch.models import build, tp
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import shardings as shr
    from repro_torch.train import step as ts

    mesh = make_fleet_mesh(2, 2)
    model, fleet = tp.model_of(mesh), shr.fleet_of(mesh)
    smoke = reduce_for_smoke(get_config(POD_ARCH))
    plan = ring_plan(("data",), (TP_NODES,), 1)
    run = _pod_run("dpsgd", compression="int8")
    step_fn = ts.make_train_step(
        build(smoke, "cuda", model=model), run, plan, constant_lr(run.eta),
        group=fleet.group, model=model,
        specs=model_specs(smoke, model.size))
    lo, hi = fleet.block(TP_NODES)
    state = ts.init_train_state(
        build(smoke, "cuda", model=model), run,
        torch.Generator(device="cuda").manual_seed(1), n_nodes=hi - lo,
        cast=shard_cast(smoke, model))
    batch = dpsgd._tree_map(lambda b: b[lo:hi], pod_batch(
        torch, smoke, 0, TP_NODES, POD_LOCK_BATCH, POD_LOCK_SEQ, "dpsgd"))
    eager, m_e = step_fn(state, batch)
    got, m_g = GraphedStep(step_fn)(state, batch)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(
        dpsgd._leaves(got), dpsgd._leaves(eager))) and torch.equal(
        m_g["loss"], m_e["loss"])
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, same)
    rank_print(f"26 (b) graph capture of the tensor-parallel Mode B step "
               f"(smoke widths, {TP_NODES} nodes x TP 2, {plan.name} int8: "
               f"the regions' all-reduces and the fleet's P2P inside): "
               f"replay bit-equal to eager (state and loss) on every rank: "
               f"{flags}; the eager step's loss {float(m_e['loss']):.4f}")
    check(all(flags) and math.isfinite(float(m_e["loss"])),
          f"26 (b) capture: replay bit-equal per rank {flags}")
    return {"captured": all(flags), "ranks": flags}


def rank_tp(torch) -> dict:
    """26 (b), every rank: gemma3-12b's Mode A at TP 4 on one node,
    published widths and depth, remat full, the step consuming its state;
    qwen2-vl-2b's Mode B at full depth (2 nodes x TP 2, none and int8);
    the family, the twin and the trainer at the smoke widths over (fleet
    2, model 2)."""
    import dataclasses
    import gc
    import math

    from repro_torch.configs import get_config
    from repro_torch.core.gossip import ring_plan
    from repro_torch.launch.mesh import make_fleet_mesh

    two = make_fleet_mesh(2, 2)
    four = make_fleet_mesh(1, TP_A_SIZE)
    out = {"allreduce": [
        rank_tp_allreduce(torch, two, (POD_BATCH, POD_SEQ,
                                       get_config(POD_ARCH).d_model)),
        rank_tp_allreduce(torch, four, (TP_A_BATCH, TP_A_SEQ,
                                        get_config(TP_A_ARCH).d_model))]}
    # the largest state first, before the other worlds' communicators hold
    # their buffers on the cards
    gemma = get_config(TP_A_ARCH)
    run = dataclasses.replace(_pod_run("allreduce"), remat="full")
    res = rank_tp_steps(
        torch, f"{TP_A_ARCH} Mode A at published widths and depth (d "
        f"{gemma.d_model}, vocab {gemma.vocab_size}, {gemma.n_layers} "
        f"layers), --nodes 1 --tp {TP_A_SIZE}, remat full, AdamW, the state "
        f"donated, {TP_A_BATCH} x {TP_A_SEQ} tokens", gemma, run, None,
        four, 1, TP_A_BATCH, TP_A_SEQ, TP_A_BATCH * TP_A_SEQ, donate=True)
    ln_v = math.log(gemma.vocab_size)
    rank_print(f"26 (b) {TP_A_ARCH} Mode A: the first loss "
               f"{res['losses'][0]:.4f} against ln V = {ln_v:.4f}")
    out["mode_a"] = dict(res, ln_v=ln_v, layers=gemma.n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(POD_ARCH)
    plan = ring_plan(("data",), (TP_NODES,), 1)
    out["mode_b"] = {}
    for comp in ("none", "int8"):
        out["mode_b"][comp] = rank_tp_steps(
            torch, f"{POD_ARCH} Mode B at full depth ({full.n_layers} "
            f"layers), {TP_NODES} nodes x TP 2, ring-1 {comp}, AdamW, "
            f"{POD_BATCH} x {POD_SEQ} tokens a node", full,
            _pod_run("dpsgd", compression=comp), plan, two, TP_NODES,
            POD_BATCH, POD_SEQ, TP_NODES * POD_BATCH * POD_SEQ,
            graphed=comp == "none")
        gc.collect()
        torch.cuda.empty_cache()
    out["family"] = rank_tp_family(torch, two)
    out.update(rank_tp_twin_and_trainer(torch))
    return out


# ---------------------------------------------------------------------------
# 27. Tensor parallelism for every family's training
# ---------------------------------------------------------------------------

TPF_FAMILIES = ("deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b",
                "recurrentgemma-2b", "rwkv6-7b", "seamless-m4t-large-v2")
TPF_BATCH, TPF_SEQ = 4, 512         # (b) a node's batch (Mode B), or the
                                    # replica's (Mode A)
TPF_NODES = 2                       # (b) Mode B and the family: 2 nodes x TP 2
TPF_A_SIZE = 4                      # (b) Mode A: one replica over 4 cards
TPF_FAMILY_BATCH, TPF_FAMILY_ROUNDS = 2, 3
TPF_SMOKE_TOL = 1e-5                # (b) the smoke widths against one card:
                                    # the loss and every gradient
TPF_ETA = {"sgd": 0.01, "adamw": 1e-3}
TPF_CALL_S = 480
# (a) flash at the rank's heads of the published configs in (b):
# (B, S, T, Hq, Hkv, D, causal, window); MLA's v is zero-padded from 128
# to q's 192 lanes before the kernel (models/mla.py)
TPF_FLASH = {
    "deepseek-v2-lite-16b MLA at tp 4": (TPF_BATCH, TPF_SEQ, TPF_SEQ, 4, 4,
                                         192, True, 0),
    "recurrentgemma-2b local at tp 2": (TPF_BATCH, TPF_SEQ, TPF_SEQ, 5, 1,
                                        256, True, 2048),
    "seamless-m4t-large-v2 encoder and cross at tp 2": (
        TPF_BATCH, TPF_SEQ // 2, TPF_SEQ // 2, 8, 8, 64, False, 0),
    "seamless-m4t-large-v2 decoder at tp 2": (
        TPF_BATCH, TPF_SEQ // 2, TPF_SEQ // 2, 8, 8, 64, True, 0),
}
# (a) the scans at the rank's channels / heads in (b): recurrentgemma-2b's
# Mode B (one node a rank, tp 2: d_rnn 2560 / 2) and rwkv6-7b's Mode A
# (tp 4: 64 heads / 4, the u of the one replica)
TPF_RGLRU = (TPF_BATCH, TPF_SEQ, 2560 // 2)
TPF_RWKV = (TPF_BATCH, TPF_SEQ, 64 // TPF_A_SIZE, 64)


def replicated_equal(torch, params, specs, model) -> list:
    """Per rank of the world: whether every leaf ``specs`` leave whole is
    bit-equal across ``model``'s ranks."""
    import torch.distributed as dist

    from repro_torch.core import dpsgd
    from repro_torch.train import shardings as shr

    same = True
    for x, sp in zip(dpsgd._leaves(params), shr.spec_leaves(specs)):
        if "model" in sp:
            continue
        parts = [torch.empty_like(x) for _ in range(model.size)]
        dist.all_gather(parts, x.contiguous(), group=model.group)
        same = same and all(torch.equal(parts[0], y) for y in parts[1:])
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, bool(same))
    return flags


def tpf_world_of_one(torch) -> dict:
    """27 (a): each new family's smoke config on a (1, 1) world (NCCL) goes
    through the tensor-parallel code with groups of one: the loss and the
    gradients bit-equal to the one-device code's, with the same
    launches."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import dpsgd
    from repro_torch.launch import mesh as lm
    from repro_torch.launch.train import model_specs
    from repro_torch.models import build, tp
    from repro_torch.train import shardings as shr

    def runs(mesh) -> dict:
        model = tp.model_of(mesh)
        out = {}
        for arch in TPF_FAMILIES:
            cfg = reduce_for_smoke(get_config(arch))
            params = build(cfg, "cuda").init(
                torch.Generator(device="cuda").manual_seed(27))
            if mesh is not None:
                params = shr.shard_model(
                    params, model_specs(cfg, model.size), model)
            api = build(cfg, "cuda", model=None if mesh is None else model)
            batch = pod_batch(torch, cfg, 0, 1, POD_LOCK_BATCH, POD_LOCK_SEQ,
                              "allreduce")
            (g, loss), n = launched(
                torch, lambda: torch.func.grad_and_value(
                    lambda p: api.loss(p, batch))(params), train_counters())
            out[arch] = ([x.clone() for x in dpsgd._leaves(g)], loss.clone(),
                         n)
        return out

    one = runs(None)
    with tempfile.TemporaryDirectory() as d:
        lm.init_world("cuda", init_method=f"file://{d}/store", rank=0,
                      world_size=1)
        try:
            mesh = lm.make_fleet_mesh(1, 1)
            before = tp_collectives()
            world = runs(mesh)
            issued = tp_collectives() != before
            print(f"27 (a) a world of {dist.get_world_size()} rank on a "
                  f"(fleet, model) = {tuple(mesh.mesh.shape)} mesh: every "
                  f"family's loss and gradient through the tensor-parallel "
                  f"code, groups of one ({'some' if issued else 'no'} "
                  f"region collective issued)")
        finally:
            dist.destroy_process_group()
    check(not issued, "27 (a): a model axis of one issued a collective")
    result = {}
    for arch in TPF_FAMILIES:
        (a, la, na), (b, lb, nb) = one[arch], world[arch]
        same = bool(torch.equal(la, lb)) and all(
            torch.equal(x, y) for x, y in zip(a, b))
        nz = {k: v for k, v in nb.items() if v}
        print(f"27 (a) {arch} smoke, the loss and its gradient: loss "
              f"{float(lb):.6f}, {'bit-equal to' if same else 'UNLIKE'} the "
              f"one-device code's; launches {nz} against "
              f"{ {k: v for k, v in na.items() if v} }")
        check(same and na == nb and any(nb.values()),
              f"27 (a) {arch}: {float(lb)} {nb} against {float(la)} {na}")
        result[arch] = nz
    return result


def tpf_scans(torch) -> dict:
    """27 (a): the RG-LRU and RWKV-6 scans and their backward kernels at
    the rank's shard shapes (``TPF_RGLRU``, ``TPF_RWKV``), against their
    plain versions (the backward summed in float64), bar x max(1, max
    |oracle|), with times beside the plain version's and the bound."""
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    gen = torch.Generator(device="cuda").manual_seed(27)
    f64 = torch.float64

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def held(got, want, bar, what):
        worst = 0.0
        for g, w_ in zip(got, want):
            if g is None:
                continue
            e = err(g, w_)
            check(e <= bar * max(1.0, float(w_.abs().max())),
                  f"27 (a) {what}: max|err| {e}")
            worst = max(worst, e)
        return worst

    def timed(kernel, plain, names, nbytes, flops, shape, e, reps):
        b_ms, b_by = cost.bound(nbytes, flops)
        return {"ms": time_ms(torch, kernel, reps=reps, rounds=3, warmup=2),
                "plain_ms": time_ms(torch, plain, reps=1, rounds=3,
                                    warmup=1),
                "library_ms": None,
                "device_ms": prof.device_ms(kernel, names, calls=5),
                "bound_ms": b_ms, "bound_by": b_by, "shape": shape,
                "max_abs_err": e}

    out = {}
    b, s, d = TPF_RGLRU
    a, x, dh = torch.sigmoid(randn(b, s, d)), randn(b, s, d), randn(b, s, d)
    h = rg.rglru_scan(a, x)
    e = held([h], [rg.rglru_scan_plain(a, x, None)], TOL_RGLRU,
             f"rglru_scan ({b},{s},{d})")
    shape = f"a, b ({b},{s},{d}) fp32"
    out["rglru_scan"] = timed(
        lambda: rg.rglru_scan(a, x), lambda: rg.rglru_scan_plain(a, x, None),
        ("rglru_scan_kernel", "Memset"), *cost.rglru_cost(b, s, d), shape, e,
        20)
    e = held(rg.rglru_scan_bwd(a, h, dh, None),
             rg.rglru_scan_bwd_plain(a, h, dh, None, acc_dtype=f64),
             TOL_RGLRU, f"rglru_scan_bwd ({b},{s},{d})")
    out["rglru_scan_bwd"] = timed(
        lambda: rg.rglru_scan_bwd(a, h, dh, None),
        lambda: rg.rglru_scan_bwd_plain(a, h, dh, None),
        ("rglru_bwd", "Memset"), *cost.rglru_bwd_cost(b, s, d, False),
        f"a, h, dh ({b},{s},{d}) fp32", e, 20)
    del a, x, dh, h
    b, s, hh, d = TPF_RWKV
    r, k, v = (randn(b, s, hh, d) for _ in range(3))
    w = torch.exp(-torch.exp(randn(b, s, hh, d) * 0.5))
    u, dy = randn(hh, d) * 0.1, randn(b, s, hh, d)
    y, _ = rw.rwkv6_scan(r, k, v, w, u)
    want, _ = rw.rwkv6_scan_plain(r, k, v, w, u, None, RWKV_CHUNK)
    e = held([y], [want], TOL_RWKV, f"rwkv6_scan ({b},{s},{hh},{d})")
    shape = f"r, k, v, w ({b},{s},{hh},{d}) fp32, u ({hh},{d})"
    out["rwkv6_scan"] = timed(
        lambda: rw.rwkv6_scan(r, k, v, w, u),
        lambda: rw.rwkv6_scan_plain(r, k, v, w, u, None, RWKV_CHUNK),
        "rwkv6_scan_kernel", *cost.rwkv_cost(b, s, hh, d), shape, e, 10)
    e = held(rw.rwkv6_scan_bwd(r, k, v, w, u, dy, None, None),
             rw.rwkv6_scan_bwd_plain(r, k, v, w, u, dy, None, None,
                                     RWKV_CHUNK, acc_dtype=f64),
             TOL_RWKV, f"rwkv6_scan_bwd ({b},{s},{hh},{d})")
    out["rwkv6_scan_bwd"] = timed(
        lambda: rw.rwkv6_scan_bwd(r, k, v, w, u, dy, None, None),
        lambda: rw.rwkv6_scan_bwd_plain(r, k, v, w, u, dy, None, None,
                                        RWKV_CHUNK),
        "rwkv6_bwd", *cost.rwkv_bwd_cost(b, s, hh, d, False, False),
        shape + ", dy", e, 3)
    for name, t in out.items():
        dev_t = t["device_ms"] if t["device_ms"] is not None else t["ms"]
        dms = "not measured" if t["device_ms"] is None \
            else f"{t['device_ms']:.4f} ms"
        print(f"27 (a) {name:15s} at the shard {t['shape']}: max|err| "
              f"{t['max_abs_err']:.3e}; {t['ms']:.4f} ms/call (device "
              f"{dms}) | plain {t['plain_ms']:.4f} ms | library none | bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / dev_t * 100:.1f} % of it")
    del r, k, v, w, u, dy, y, want
    torch.cuda.empty_cache()
    return out


def tpf_scan_slices(torch) -> bool:
    """27 (a): the RWKV-6 scan and its backward kernel on rank 1's heads
    at tp 4 (``TPF_RWKV``), taken as strided views of whole (B, S, H, D)
    tensors as a shard's projection hands them over, bit-equal to the
    whole call's heads. (The RG-LRU's forward takes its look-back from
    whichever chunk has published, so two whole calls already differ in
    the last bit: it is held against its plain version above.)"""
    from repro_torch.kernels import rwkv6_scan as rw

    gen = torch.Generator(device="cuda").manual_seed(28)
    b, s, hh, d = TPF_RWKV
    heads = hh * TPF_A_SIZE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, k, v, dy = (randn(b, s, heads, d) for _ in range(4))
    w = torch.exp(-torch.exp(randn(b, s, heads, d) * 0.5))
    u = randn(heads, d) * 0.1
    whole = (*rw.rwkv6_scan(r, k, v, w, u),
             *rw.rwkv6_scan_bwd(r, k, v, w, u, dy)[:5])
    lo, hi = hh, 2 * hh
    part = (*rw.rwkv6_scan(*(x[:, :, lo:hi] for x in (r, k, v, w)),
                           u[lo:hi]),
            *rw.rwkv6_scan_bwd(*(x[:, :, lo:hi] for x in (r, k, v, w)),
                               u[lo:hi], dy[:, :, lo:hi])[:5])
    cut = (whole[0][:, :, lo:hi], whole[1][:, lo:hi],
           *(x[:, :, lo:hi] for x in whole[2:6]), whole[6][:, lo:hi])
    same = all(torch.equal(x, y) for x, y in zip(part, cut))
    print(f"27 (a) rwkv6_scan and rwkv6_scan_bwd on heads [{lo}, {hi}) of "
          f"{heads} as strided views ({b},{s},{hh},{d}): y, the final "
          f"state, dr, dk, dv, dw and du bit-equal to the whole call's: "
          f"{same}")
    check(same, "27 (a) the RWKV-6 kernels on a shard's strided heads "
          "differ from the whole call's")
    del r, k, v, dy, w, u, whole, part, cut
    torch.cuda.empty_cache()
    return same


def tpf_four_cards(torch) -> dict:
    """27 (b): the (fleet, model) world on four cards, one a rank."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    out = torchrun(TP_CARDS, [str(ROOT / Path(__file__).name),
                              "--fleet-rank", "tpf"],
                   "27 (b) tensor parallelism of every family",
                   timeout=TPF_CALL_S)
    print("\n".join(ln for ln in out.splitlines()
                    if ln.startswith("27 (b)")))
    return fleet_result(out, "27 (b) tensor parallelism of every family")


def phase_tpf(torch) -> dict:
    phase("27. tensor parallelism for every family's training: each new "
          "family through the tensor-parallel code on a (1, 1) world, the "
          "scans and flash at the rank's shard shapes, and with four cards "
          "the (fleet, model) worlds")
    result = {"a": tpf_world_of_one(torch), "scans": tpf_scans(torch),
              "slices": tpf_scan_slices(torch),
              "flash": tp_flash(torch, TPF_FLASH, "27 (a)")}
    if torch.cuda.device_count() >= TP_CARDS:
        result["b"] = tpf_four_cards(torch)
    else:
        print(f"27 (b) needs {TP_CARDS} cards, {torch.cuda.device_count()} "
              "visible: not run")
    return result


# ---------------------------------------------------------------------------
# The ranks of 27 (b) (chip_smoke.py --fleet-rank tpf, four ranks)
# ---------------------------------------------------------------------------

def matmul64(x, w):
    """A weight product formed in float64 and rounded to x's dtype: each
    element correctly rounded, so a column shard's products are the whole
    product's columns whatever kernel forms them."""
    from repro_torch.models import remat

    return remat.__dict__["_matmul_fp32"](x.double(), w.double()).to(x.dtype)


@contextlib.contextmanager
def float64_products():
    """Every weight product of the models (``remat._matmul``) formed in
    float64 and rounded (``matmul64``), on every side of a comparison:
    27 (b)'s rwkv6-7b smoke and ``tools/tp_witness.py``'s "float64
    products" mode. On four H100s the shards' fp32 GEMMs are not the whole
    GEMM's columns bit for bit, and rwkv6-7b's random smoke weights carry
    that rounding to 2.09e-4 in the embedding gradient; with the products
    rounded from float64 tp against the card alone reads 5.96e-7 (tp 2)
    and 3.58e-7 (tp 4)."""
    from repro_torch.models import remat

    remat._matmul_fp32 = remat._matmul
    remat._matmul = matmul64
    try:
        yield
    finally:
        remat._matmul = remat.__dict__.pop("_matmul_fp32")


# the smoke configs 27 (b) holds with the products formed in float64 on
# both sides (the fp32 gap and the rounding sensitivity printed beside)
TPF_SMOKE_F64 = ("rwkv6-7b",)


def rank_tpf_smoke(torch, meshes: dict) -> dict:
    """Every new family's smoke config at tp 2 and 4: the loss and the
    gathered gradients against the same parameters and batch on this
    rank's card alone, within ``TPF_SMOKE_TOL``, and the launches. The
    archs of ``TPF_SMOKE_F64`` are held with every weight product formed
    in float64 on both sides (``float64_products``); their fp32 gap and
    the gradient's rounding sensitivity alone (fp32 products against
    products rounded from float64) are printed, not barred."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.train import model_specs
    from repro_torch.models import build, tp
    from repro_torch.train import shardings as shr

    def worst_of(whole, g1):
        """(the largest gradient difference, its leaf path)."""
        return max((float((a - b).abs().max()), path)
                   for (path, a), (_, b) in zip(
                       shr._with_path(whole), shr._with_path(g1)))

    out = {}
    for arch in TPF_FAMILIES:
        cfg = reduce_for_smoke(get_config(arch))
        full = build(cfg, "cuda").init(
            torch.Generator(device="cuda").manual_seed(27))
        batch = pod_batch(torch, cfg, 0, 1, POD_LOCK_BATCH, POD_LOCK_SEQ,
                          "allreduce")
        f64 = arch in TPF_SMOKE_F64
        mode = float64_products if f64 else contextlib.nullcontext

        def alone():
            return torch.func.grad_and_value(
                lambda p: build(cfg, "cuda").loss(p, batch))(full)
        with mode():
            g1, l1 = alone()
        if f64:
            g32, l32 = alone()
            sens = worst_of(g32, g1)
            rank_print(f"27 (b) {arch} smoke alone: the gradient's rounding "
                       f"sensitivity (fp32 products against products "
                       f"rounded from float64) {sens[0]:.3e} at "
                       f"{'/'.join(map(str, sens[1]))}, loss "
                       f"{abs(float(l32) - float(l1)):.3e} (not a bar)")
        for size, mesh in meshes.items():
            model = tp.model_of(mesh)
            specs = model_specs(cfg, size)
            api = build(cfg, "cuda", model=model)
            local = shr.shard_model(full, specs, model)

            def step():
                return torch.func.grad_and_value(
                    lambda p: api.loss(p, batch))(local)
            with mode():
                (g, loss), n = launched(torch, step, train_counters())
            whole = shr.gather_model(g, specs, model, dst=None)
            worst = worst_of(whole, g1)
            got = [None] * dist.get_world_size()
            dist.all_gather_object(got, (abs(float(loss) - float(l1)),
                                         worst[0]))
            key = f"{arch} tp {size}"
            out[key] = {
                "loss": float(loss), "loss_diff_grad_diff": got,
                "worst_leaf": "/".join(map(str, worst[1])),
                "launches": {k: v for k, v in n.items() if v},
                "products": "float64" if f64 else "fp32"}
            if f64:
                g_, l_ = step()
                w32 = worst_of(shr.gather_model(g_, specs, model, dst=None),
                               g32)
                out[key]["fp32_gap"] = [abs(float(l_) - float(l32)), w32[0],
                                        "/".join(map(str, w32[1]))]
                rank_print(f"27 (b) {arch} smoke at tp {size}, fp32 products "
                           f"on both sides (not a bar): loss difference "
                           f"{out[key]['fp32_gap'][0]:.3e}, the largest "
                           f"gradient difference {w32[0]:.3e} at "
                           f"{out[key]['fp32_gap'][2]}")
                del g_, l_
            rank_print(f"27 (b) {arch} smoke at tp {size}"
                       f"{', every weight product formed in float64 on both sides' if f64 else ''}"
                       f": loss {float(loss):.6f}; against the card alone "
                       f"per rank (loss difference, the largest gradient "
                       f"difference) {got}, that gradient's leaf "
                       f"{out[key]['worst_leaf']} (bar {TPF_SMOKE_TOL}); "
                       f"rank 0's launches {out[key]['launches']}")
            check(all(dl <= TPF_SMOKE_TOL and dg <= TPF_SMOKE_TOL
                      for dl, dg in got),
                  f"27 (b) {arch} smoke at tp {size}: {got}")
            del g, whole, local
    return out


def rank_tpf_family(torch, mesh) -> dict:
    """recurrentgemma-2b's train-on-trace family at its published widths
    and depth over (fleet 2, model 2): 2 nodes on fading, 3 rounds, eager:
    losses, ms a round, tokens/s, peak GiB, the regions' collectives, the
    launches per rank and the traced call's idle share."""
    import gc
    import math

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.sim import batch as tb
    from repro_torch.sim import get_scenario, precompute_traces
    from repro_torch.utils import profile

    mcfg = get_config("recurrentgemma-2b")
    ad = tb.transformer_adapter(mcfg, batch=TPF_FAMILY_BATCH,
                                seq_len=TPF_SEQ, eval_batch=TPF_FAMILY_BATCH,
                                device="cuda")
    cfg = get_scenario("fading", n_nodes=TPF_NODES,
                       model_bits=ad.model_bits, model_shapes=ad.param_shapes,
                       eval_every_rounds=TPF_FAMILY_ROUNDS)

    def family(rounds: int):
        return tb.train_model_on_traces(
            ad, [cfg], rounds, trace_batch=precompute_traces([cfg], rounds),
            mesh=mesh, device="cuda")[1]

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    c0 = tp_collectives()
    ran = []        # one traced call: its parameters are drawn on the host
    t0 = time.perf_counter()
    traced = profile.trace(lambda: ran.append(launched(
        torch, lambda: family(TPF_FAMILY_ROUNDS),
        {**fleet_counters(), **train_counters()})))
    wall_ms = (time.perf_counter() - t0) * 1e3
    (res, launches), = ran
    c1 = tp_collectives()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = res["losses"][0].tolist()
    tokens = TPF_NODES * TPF_FAMILY_BATCH * TPF_SEQ * TPF_FAMILY_ROUNDS
    wall = traced.get("wall_ms") or wall_ms
    out = {"losses": losses, "ms_a_round": wall_ms / TPF_FAMILY_ROUNDS,
           "tokens_s": tokens / wall_ms * 1e3, "ln_v": math.log(
               mcfg.vocab_size),
           "collectives": {k: (c1[k][0] - c0[k][0], c1[k][1] - c0[k][1])
                           for k in c1},
           "launches": {k: v for k, v in launches.items() if v},
           "busy_ms": traced["busy_ms"],
           "idle": 1.0 - traced["busy_ms"] / wall if wall else None,
           "top": [(n[:60], round(t_, 3), c)
                   for n, t_, c in traced["top"][:8]]}
    for key, value in (("peak_gib", round(peak, 3)),
                       ("launches_by_rank", out["launches"])):
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, value)
        out[key] = got
    rank_print(f"27 (b) recurrentgemma-2b train-on-trace at its published "
               f"widths and depth ({mcfg.n_layers} layers) over (fleet 2, "
               f"model 2): {cfg.n_nodes} nodes on fading, batch "
               f"{TPF_FAMILY_BATCH} x {TPF_SEQ} a node, {TPF_FAMILY_ROUNDS} "
               f"rounds, eager: losses {losses} (the first against ln V = "
               f"{out['ln_v']:.4f}); {out['ms_a_round']:.2f} ms a round (the "
               f"call's wall over its rounds: set-up, the parameters drawn "
               f"on the host, the final gathers and the evaluation "
               f"included), {out['tokens_s']:.0f} tokens/s; peak GiB per "
               f"rank {out['peak_gib']}; the regions' collectives (calls, "
               f"bytes) {out['collectives']}; launches per rank "
               f"{out['launches_by_rank']}; the call traced: busy "
               f"{out['busy_ms']:.2f} ms of {wall:.2f} (idle "
               f"{out['idle']:.4f}), the largest: " + "; ".join(
                   f"{n} {t_} ms x{c}" for n, t_, c in out["top"][:6]))
    check(all(math.isfinite(v) for v in losses)
          and all(g.get("rglru_scan_bwd") and g.get("flash_attention_bwd")
                  for g in out["launches_by_rank"]),
          f"27 (b) family: {losses} {out['launches_by_rank']}")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rank_tpf(torch) -> dict:
    """27 (b), every rank: deepseek-v2-lite-16b's and rwkv6-7b's Mode A at
    TP 4 (published widths and depth, remat full, AdamW, the state
    donated), recurrentgemma-2b's Mode B (2 nodes x TP 2, ring-1, SGD,
    none and int8) and seamless-m4t-large-v2's (none, AdamW), the
    recurrentgemma-2b family over (2, 2), and every new family's smoke
    config at tp 2 and 4 against the card alone."""
    import dataclasses
    import gc
    import math

    from repro_torch.configs import get_config
    from repro_torch.core.gossip import ring_plan
    from repro_torch.launch.mesh import make_fleet_mesh

    two = make_fleet_mesh(2, 2)
    four = make_fleet_mesh(1, TPF_A_SIZE)
    run_a = dataclasses.replace(_pod_run("allreduce"), remat="full")
    plan = ring_plan(("data",), (TPF_NODES,), 1)
    out = {}

    def ran(key, cfg, res):
        ln_v = math.log(cfg.vocab_size)
        rank_print(f"27 (b) {key}: the first loss {res['losses'][0]:.4f} "
                   f"against ln V = {ln_v:.4f}")
        out[key] = dict(res, ln_v=ln_v, layers=cfg.n_layers)
        gc.collect()
        torch.cuda.empty_cache()

    # the largest states first, before the other worlds' communicators
    # hold their buffers on the cards
    for arch in ("deepseek-v2-lite-16b", "rwkv6-7b"):
        cfg = get_config(arch)
        ran(f"{arch} Mode A", cfg, rank_tp_steps(
            torch, f"{arch} Mode A at published widths and depth (d "
            f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.n_layers} layers), "
            f"--nodes 1 --tp {TPF_A_SIZE}, remat full, AdamW, the state "
            f"donated, {TPF_BATCH} x {TPF_SEQ} tokens", cfg, run_a, None,
            four, 1, TPF_BATCH, TPF_SEQ, TPF_BATCH * TPF_SEQ, donate=True,
            label="27 (b)", replicated=True))
    # recurrentgemma-2b's Mode B takes the paper's plain SGD update (Eq.
    # 5) and runs eager, as launch.train runs a step through split RG-LRU
    # channels (its capture hung on four H100s)
    for arch, comps, opt in (("recurrentgemma-2b", ("none", "int8"), "sgd"),
                             ("seamless-m4t-large-v2", ("none",), "adamw")):
        cfg = get_config(arch)
        for comp in comps:
            ran(f"{arch} Mode B {comp}", cfg, rank_tp_steps(
                torch, f"{arch} Mode B at published widths and depth "
                f"({cfg.n_layers} layers), {TPF_NODES} nodes x TP 2, ring-1 "
                f"{comp}, {opt}, {TPF_BATCH} x {TPF_SEQ} tokens a node",
                cfg, _pod_run("dpsgd", optimizer=opt, eta=TPF_ETA[opt],
                              compression=comp),
                plan, two, TPF_NODES, TPF_BATCH, TPF_SEQ,
                TPF_NODES * TPF_BATCH * TPF_SEQ, label="27 (b)",
                replicated=True))
    out["family"] = rank_tpf_family(torch, two)
    out["smoke"] = rank_tpf_smoke(torch, {2: two, 4: four})
    return out


# ---------------------------------------------------------------------------
# 28. Serving under tensor parallelism
# ---------------------------------------------------------------------------

TPS_ARCH = "phi3.5-moe-42b-a6.6b"    # (b) the target: 77.99 GiB in bf16
TPS_SIZE = 4                         # (b) the model axis: four cards
# (a) every served family's smoke config through the tensor-parallel
# serving code on a (1, 1) world
TPS_SMOKE = ("qwen2.5-14b", "recurrentgemma-2b", "rwkv6-7b",
             "deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b",
             "seamless-m4t-large-v2")
TPS_SMOKE_BATCH, TPS_SMOKE_PROMPT, TPS_SMOKE_STEPS = 2, 40, 3
# (b) the served archs at full width, depth cut so that each fits one card
# alone in fp32 beside its shard, teacher-forced at TF_PROMPT (batch 1,
# TF_STEPS decode steps) against the card alone: {arch: layers}; an
# encoder-decoder's layers are half encoder, half decoder
TPS_TF = {"phi3.5-moe-42b-a6.6b": 4, "recurrentgemma-2b": 3, "rwkv6-7b": 4,
          "deepseek-v2-lite-16b": 4, "seamless-m4t-large-v2": 4}
TPS_SPLIT_HEADS = 10                 # (b) the smoke training's q head split
TPS_CALL_S = 900
TPS_PEAK_TOL = 0.10                  # (b) the dry run against the card
# (a) flash at the rank's heads of (b)'s serves, (B, S, T, Hq, Hkv, D,
# causal, window); recurrentgemma-2b's q head split gathers every q head
TPS_FLASH = {
    "phi3.5-moe-42b-a6.6b at tp 4": (SERVE_BATCH, SERVE_PROMPT,
                                     SERVE_PROMPT, 8, 2, 128, True, 0),
    "recurrentgemma-2b local at tp 4, q heads gathered whole": (
        SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 10, 1, 256, True, 2048),
    "deepseek-v2-lite-16b MLA at tp 4": (SERVE_BATCH, SERVE_PROMPT,
                                         SERVE_PROMPT, 4, 4, 192, True, 0),
    "seamless-m4t-large-v2 encoder and cross at tp 4": (
        SERVE_BATCH, SERVE_PROMPT // 2, SERVE_PROMPT // 2, 4, 4, 64, False,
        0),
    "seamless-m4t-large-v2 decoder at tp 4": (
        SERVE_BATCH, SERVE_PROMPT // 2, SERVE_PROMPT // 2, 4, 4, 64, True, 0),
}
# (a) the scans at the rank's channels / heads: recurrentgemma-2b's
# d_rnn 2560 / 4 in prefill and decode, rwkv6-7b's 64 heads / 4
TPS_RGLRU = (SERVE_BATCH, SERVE_PROMPT, 2560 // TPS_SIZE)
TPS_RWKV = (SERVE_BATCH, SERVE_PROMPT, 64 // TPS_SIZE, 64)


def serve_counters() -> dict:
    """The kernels a serve launches, by name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    return {"flash_attention": fa.flash_attention,
            "rglru_scan": rg.rglru_scan, "rwkv6_scan": rw.rwkv6_scan}


def tps_smoke_cfg(arch: str):
    from repro_torch.configs import get_config, reduce_for_smoke

    return reduce_for_smoke(get_config(arch))


def tps_prompt(torch, cfg, batch: int, prompt: int, steps: int,
               seed: int) -> tuple:
    """A prompt (the encoder-decoder's: ``prompt`` source frames and target
    tokens) and ``steps`` tokens to decode, drawn on the card from
    ``seed``: the same on every rank."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt + steps),
                           generator=gen, device="cuda")
    inputs = {"tokens": tokens[:, :prompt]}
    if cfg.is_encdec:
        inputs["src_embeds"] = torch.randn(
            (batch, prompt, cfg.d_model), generator=gen,
            device="cuda").to(getattr(torch, cfg.dtype))
    return inputs, tokens


def tps_forced(api, params, inputs: dict, tokens, prompt: int,
               steps: int, max_len: int) -> tuple:
    """Prefill, then ``steps`` decode steps fed the given tokens: (the
    logits of each call, the last cache)."""
    logits, cache = api.prefill(params, inputs, max_len=max_len)
    out = [logits]
    for i in range(steps):
        logits, cache = api.decode_step(params, tokens[:, prompt + i], cache,
                                        prompt + i)
        out.append(logits)
    return out, cache


def tps_world_of_one(torch) -> dict:
    """28 (a): every served family's smoke config on a (1, 1) world (NCCL)
    through the tensor-parallel serving code with groups of one: the
    prefill and decode logits and the caches bit-equal to one-device
    serving, with the same launches."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import dpsgd
    from repro_torch.launch import mesh as lm
    from repro_torch.launch.train import model_specs
    from repro_torch.models import build, tp
    from repro_torch.train import shardings as shr

    b, s, n = TPS_SMOKE_BATCH, TPS_SMOKE_PROMPT, TPS_SMOKE_STEPS

    def runs(mesh) -> dict:
        model = tp.model_of(mesh)
        out = {}
        for arch in TPS_SMOKE:
            cfg = tps_smoke_cfg(arch)
            params = build(cfg, "cuda").init(
                torch.Generator(device="cuda").manual_seed(28))
            if mesh is not None:
                params = shr.shard_model(
                    params, model_specs(cfg, model.size), model)
            api = build(cfg, "cuda", model=None if mesh is None else model)
            inputs, tokens = tps_prompt(torch, cfg, b, s, n, 29)
            (logits, cache), got = launched(
                torch, lambda: tps_forced(api, params, inputs, tokens, s, n,
                                          s + n + 1), serve_counters())
            out[arch] = ([x.clone() for x in logits],
                         [x.clone() for x in dpsgd._leaves(cache)], got)
        return out

    one = runs(None)
    with tempfile.TemporaryDirectory() as d:
        lm.init_world("cuda", init_method=f"file://{d}/store", rank=0,
                      world_size=1)
        try:
            mesh = lm.make_fleet_mesh(1, 1)
            before = tp_collectives()
            world = runs(mesh)
            issued = tp_collectives() != before
            print(f"28 (a) a world of {dist.get_world_size()} rank on a "
                  f"(fleet, model) = {tuple(mesh.mesh.shape)} mesh: every "
                  f"served family's prefill and {n} decode steps through "
                  f"the tensor-parallel serving code, groups of one "
                  f"({'some' if issued else 'no'} region collective issued)")
        finally:
            dist.destroy_process_group()
    check(not issued, "28 (a): a model axis of one issued a collective")
    result = {}
    for arch in TPS_SMOKE:
        (la, ca, na), (lb, cb, nb) = one[arch], world[arch]
        same = all(torch.equal(x, y) for x, y in zip(la + ca, lb + cb))
        nz = {k: v for k, v in nb.items() if v}
        print(f"28 (a) {arch} smoke, batch {b}, prompt {s}, {n} decode "
              f"steps: logits and caches "
              f"{'bit-equal to' if same else 'UNLIKE'} one-device "
              f"serving's; launches {nz} against "
              f"{ {k: v for k, v in na.items() if v} }")
        check(same and na == nb, f"28 (a) {arch}: {nb} against {na}")
        result[arch] = nz
    return result


def tps_scans(torch) -> dict:
    """28 (a): the RG-LRU scan at the rank's channels in prefill (the
    chained path) and decode (S = 1, from h0) and the RWKV-6 scan at the
    rank's heads from s0, against their plain versions under
    tests/test_kernels.py's bars, with times beside the plain version's
    and the bound."""
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    gen = torch.Generator(device="cuda").manual_seed(28)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def row(kernel, plain, names, nbytes, flops, shape, e, reps):
        b_ms, b_by = cost.bound(nbytes, flops)
        return {"ms": time_ms(torch, kernel, reps=reps, rounds=3, warmup=2),
                "plain_ms": time_ms(torch, plain, reps=1, rounds=3,
                                    warmup=1),
                "library_ms": None,
                "device_ms": prof.device_ms(kernel, names, calls=5),
                "bound_ms": b_ms, "bound_by": b_by, "shape": shape,
                "max_abs_err": e}

    out = {}
    b, s, d = TPS_RGLRU
    for steps in (s, 1):
        a, x = torch.sigmoid(randn(b, steps, d)), randn(b, steps, d)
        h0 = randn(b, d)
        e = err(rg.rglru_scan(a, x, h0), rg.rglru_scan_plain(a, x, h0))
        check(e <= TOL_RGLRU, f"28 (a) rglru_scan ({b},{steps},{d}): {e}")
        key = "rglru_scan" if steps > 1 else "rglru_scan decode"
        out[key] = row(lambda: rg.rglru_scan(a, x, h0),
                       lambda: rg.rglru_scan_plain(a, x, h0),
                       ("rglru_scan_kernel", "Memset"),
                       *cost.rglru_cost(b, steps, d),
                       f"a, b ({b},{steps},{d}) fp32, h0 ({b},{d})", e,
                       20 if steps > 1 else 100)
    b, s, hh, d = TPS_RWKV
    r, k, v = (randn(b, s, hh, d) for _ in range(3))
    w = torch.exp(-torch.exp(randn(b, s, hh, d) * 0.5))
    u, s0 = randn(hh, d) * 0.1, randn(b, hh, d, d) * 0.1
    y, sf = rw.rwkv6_scan(r, k, v, w, u, s0)
    y_p, sf_p = rw.rwkv6_scan_plain(r, k, v, w, u, s0, RWKV_CHUNK)
    e = max(err(y, y_p), err(sf, sf_p))
    check(e <= TOL_RWKV * max(1.0, float(y_p.abs().max())),
          f"28 (a) rwkv6_scan ({b},{s},{hh},{d}): {e}")
    out["rwkv6_scan"] = row(
        lambda: rw.rwkv6_scan(r, k, v, w, u, s0),
        lambda: rw.rwkv6_scan_plain(r, k, v, w, u, s0, RWKV_CHUNK),
        "rwkv6_scan_kernel", *cost.rwkv_cost(b, s, hh, d),
        f"r, k, v, w ({b},{s},{hh},{d}) fp32, u ({hh},{d}), s0", e, 10)
    for name, t in out.items():
        dev_t = t["device_ms"] if t["device_ms"] is not None else t["ms"]
        dms = "not measured" if t["device_ms"] is None \
            else f"{t['device_ms']:.4f} ms"
        print(f"28 (a) {name:17s} at the shard {t['shape']}: max|err| "
              f"{t['max_abs_err']:.3e}; {t['ms']:.4f} ms/call (device "
              f"{dms}) | plain {t['plain_ms']:.4f} ms | library none | bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / dev_t * 100:.1f} % of it")
    del r, k, v, w, u, s0, y, sf, y_p, sf_p
    torch.cuda.empty_cache()
    return out


def tps_dry_run(torch) -> dict:
    """The dry run's tp4 cell of (b)'s serve: rank 0 of (fleet 1, model
    4) in torch's fake process group (on the card's torch: the fake group
    runs there too), its per-rank peak and the model axis's collectives."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr

    with dr.fake_world(dr.MESHES["tp4"][0]) as world:
        cell = dr.serve_cell(get_config(TPS_ARCH), batch=SERVE_BATCH,
                             prompt_len=SERVE_PROMPT,
                             max_len=SERVE_PROMPT + SERVE_GEN, world=world)
    print(f"28 (a) the dry run's tp4 cell of {TPS_ARCH}'s serve (batch "
          f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, one decode step), rank 0 "
          f"of (fleet 1, model 4) in the fake process group: weights "
          f"{cell['params_bytes'] / 2**30:.3f} GiB, cache "
          f"{cell['cache_bytes'] / 2**30:.3f} GiB, peak "
          f"{cell['peak_bytes'] / 2**30:.3f} GiB, flops {cell['flops']:.4g},"
          f" the model axis's collectives {cell['model_collectives']}")
    return cell


def tps_serve_demo(torch) -> dict:
    """28 (a): ``repro_torch.examples.serve_demo`` on the card (the JAX
    script's twin; its tokens are held equal to the JAX script's on the
    CPU, tests/test_torch_serve.py): its lines, and its launches."""
    import contextlib
    import io

    from repro_torch.examples import serve_demo

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code, n = launched(
            torch, lambda: serve_demo.main(["--device", "cuda"]),
            serve_counters())
    lines = buf.getvalue().strip().splitlines()
    for ln in lines:
        print(f"28 (a) serve_demo: {ln}")
    check(code == 0 and len(lines) == len(serve_demo.ARCHS) and all(
        "sample tokens" in ln for ln in lines),
        f"28 (a) serve_demo: exit {code}, {lines}")
    nz = {k: v for k, v in n.items() if v}
    print(f"28 (a) serve_demo launches {nz}")
    return nz


def tps_four_cards(torch, dry: dict) -> dict:
    """28 (b): the world of four cards, one a rank, and the dry run's peak
    against rank 0's."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    out = torchrun(TPS_SIZE, [str(ROOT / Path(__file__).name),
                              "--fleet-rank", "tps"],
                   "28 (b) serving under tensor parallelism",
                   timeout=TPS_CALL_S)
    print("\n".join(ln for ln in out.splitlines()
                    if ln.startswith("28 (b)")))
    res = fleet_result(out, "28 (b) serving under tensor parallelism")
    serve = res["serve"]
    want = serve["peak_bytes"] - serve["base_bytes"]
    off = dry["peak_bytes"] / want - 1
    print(f"28 (b) the dry run's tp4 peak {dry['peak_bytes'] / 2**30:.3f} "
          f"GiB against rank 0's max_memory_allocated less what it held "
          f"before the serve {want / 2**30:.3f} GiB: {off * 100:+.2f} % "
          f"(bar {TPS_PEAK_TOL * 100:.0f} %)")
    check(abs(off) <= TPS_PEAK_TOL,
          f"28 (b) the dry run's peak {dry['peak_bytes']} against {want}")
    res["dry_peak_off"] = off
    return res


def phase_tps(torch) -> dict:
    phase("28. serving under tensor parallelism: every served family "
          "through the tensor-parallel serving code on a (1, 1) world, "
          "flash and the scans at the rank's shard shapes, the dry run's "
          "tp4 cell, and with four cards phi3.5-moe-42b-a6.6b served at "
          "full width and depth over them, every served arch held against "
          "the card alone")
    result = {"a": tps_world_of_one(torch), "demo": tps_serve_demo(torch),
              "scans": tps_scans(torch),
              "flash": tp_flash(torch, TPS_FLASH, "28 (a)"),
              "dry": tps_dry_run(torch)}
    if torch.cuda.device_count() >= TPS_SIZE:
        result["b"] = tps_four_cards(torch, result["dry"])
    else:
        print(f"28 (b) needs {TPS_SIZE} cards, {torch.cuda.device_count()} "
              "visible: not run")
    return result


# ---------------------------------------------------------------------------
# The ranks of 28 (b) (chip_smoke.py --fleet-rank tps, four ranks)
# ---------------------------------------------------------------------------

def rank_tps_serve(torch, model) -> dict:
    """phi3.5-moe-42b-a6.6b at its published widths and depth over the
    model axis: ``launch.serve.generate(tp=)`` at (SERVE_BATCH,
    SERVE_PROMPT, SERVE_GEN) in bf16 (prefill s, tok/s, peak, launches,
    every rank's tokens equal), then DECODE_PROFILE_STEPS decode steps
    timed and profiled (ms a step, idle share, collectives a step)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.models import build, tp
    from repro_torch.utils import profile

    cfg = get_config(TPS_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (out, n) = launched(torch, lambda: serve.generate(
        cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
        device="cuda", tp=model), serve_counters())
    peak = torch.cuda.max_memory_allocated()
    tokens = [None] * dist.get_world_size()
    dist.all_gather_object(tokens, out["tokens"].tolist())
    same = all(t == tokens[0] for t in tokens)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    finite = bool(torch.isfinite(out["logits"].float()).all())
    rank_print(f"28 (b) {cfg.name} at full width and depth ({cfg.n_layers} "
               f"layers, {cfg.moe.n_experts} experts / {TPS_SIZE} a rank), "
               f"tp {TPS_SIZE}, bf16, batch {SERVE_BATCH}, prompt "
               f"{SERVE_PROMPT}, {SERVE_GEN} tokens: prefill "
               f"{out['prefill_s']:.4f} s, decode {out['decode_s']:.4f} s = "
               f"{out['tok_per_s']:.2f} tok/s; peak per rank "
               f"{[round(p / 2**30, 3) for p in peaks]} GiB; launches "
               f"{ {k: v for k, v in n.items() if v} }; every rank's tokens "
               f"{'equal' if same else 'DIFFER'}; sample "
               f"{out['tokens'][0, :8].tolist()}")
    check(same, "28 (b) the ranks sampled different tokens")
    check(finite, "28 (b) non-finite logits")
    check(tuple(out["tokens"].shape) == (SERVE_BATCH, SERVE_GEN),
          f"28 (b) tokens {tuple(out['tokens'].shape)}")
    check(n["flash_attention"] == cfg.n_layers,
          f"28 (b) flash launches {n} (want {cfg.n_layers} in prefill)")
    res = {"prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
           "tok_per_s": out["tok_per_s"], "peak_bytes": peak,
           "base_bytes": base, "peaks": peaks,
           "launches": {k: v for k, v in n.items() if v}}
    del out
    torch.cuda.empty_cache()

    # the decode steps again, timed and profiled, beside the collectives
    api = build(cfg, "cuda", model=model)
    rng = torch.Generator(device="cuda").manual_seed(1)
    params = serve.init_serving_params(api, rng, model)
    inputs = api.make_inputs(ShapeConfig("serve", SERVE_PROMPT, SERVE_BATCH,
                                         "prefill"), rng,
                             batch_override=SERVE_BATCH)
    state = {}
    state["logits"], state["cache"] = api.prefill(
        params, inputs, max_len=SERVE_PROMPT + 2 * DECODE_PROFILE_STEPS + 1)

    def decode(start):
        tok = torch.argmax(state["logits"], -1)
        for i in range(DECODE_PROFILE_STEPS):
            state["logits"], state["cache"] = api.decode_step(
                params, tok, state["cache"], start + i)
            tok = torch.argmax(state["logits"], -1)
    before = {k: list(v) for k, v in tp.COLLECTIVES.items()}
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    decode(SERVE_PROMPT)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / DECODE_PROFILE_STEPS
    per_step = {k: [(tp.COLLECTIVES[k][0] - before[k][0])
                    / DECODE_PROFILE_STEPS,
                    (tp.COLLECTIVES[k][1] - before[k][1])
                    / DECODE_PROFILE_STEPS] for k in before}
    rows = profile.device_profile(
        lambda: decode(SERVE_PROMPT + DECODE_PROFILE_STEPS),
        DECODE_PROFILE_STEPS)
    idle = None
    if rows:
        busy = sum(r[1] for r in rows)
        idle = 1 - busy / ms
    rank_print(f"28 (b) {cfg.name} decode, {DECODE_PROFILE_STEPS} steps: "
               f"{ms:.4f} ms a step on rank 0's host clock; idle share "
               f"{'not measured' if idle is None else f'{idle:.3f}'}; a "
               f"step's collectives per rank {per_step} ([calls, bytes]); "
               f"top device operations (ms/step, launches/step) "
               f"{[(r[0][:60], round(r[1], 4), r[2]) for r in rows[:6]]}")
    res.update({"decode_ms": ms, "decode_idle_share": idle,
                "collectives_per_step": per_step})
    del params, state, inputs
    torch.cuda.empty_cache()
    return res


def rank_tps_forced(torch, model) -> dict:
    """Every served arch at full width (``TPS_TF``'s depths) in fp32,
    teacher-forced at TF_PROMPT against the same parameters and tokens on
    this rank's card alone: the prefill within 2e-4, each decode step
    within 2e-4 + 3 x the floor (phases 9 and 13's bars: apply over the
    prompt alone against apply over the whole sequence, on the card
    alone); greedy tokens compared and printed, not barred. A MoE runs
    at capacity factor n_experts / top_k (drop-free, as phase 13)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.train import model_specs
    from repro_torch.models import build, encdec, transformer
    from repro_torch.train import shardings as shr

    out = {}
    for arch, layers in TPS_TF.items():
        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  n_layers=layers)
        if cfg.is_encdec:
            cfg = dataclasses.replace(cfg, encoder_layers=layers // 2)
        if cfg.moe is not None:
            mc = cfg.moe
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                mc, capacity_factor=mc.n_experts / mc.top_k))
        prompt = TF_PROMPT // 2 if cfg.is_encdec else TF_PROMPT
        full = build(cfg, "cuda").init(
            torch.Generator(device="cuda").manual_seed(28))
        inputs, tokens = tps_prompt(torch, cfg, 1, prompt, TF_STEPS, 30)
        max_len = prompt + TF_STEPS + 1
        alone, _ = tps_forced(build(cfg, "cuda"), full, inputs, tokens,
                              prompt, TF_STEPS, max_len)

        def prefill_ms(api, params):
            """One more prefill, timed on the host clock after a sync."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.prefill(params, inputs, max_len=max_len)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        alone_ms = prefill_ms(build(cfg, "cuda"), full)

        def apply(t):
            if cfg.is_encdec:
                return encdec.apply(cfg, full, inputs["src_embeds"], t)
            return transformer.apply(cfg, full, t)
        short = apply(tokens[:, :prompt])[:, -1]
        floor = err(short, apply(tokens)[:, prompt - 1])
        del short
        local = shr.shard_model(full, model_specs(cfg, model.size), model)
        del full
        torch.cuda.empty_cache()
        (served, _), n = launched(torch, lambda: tps_forced(
            build(cfg, "cuda", model=model), local, inputs, tokens, prompt,
            TF_STEPS, max_len), serve_counters())
        tp_ms = prefill_ms(build(cfg, "cuda", model=model), local)
        errs = [err(a, b) for a, b in zip(served, alone)]
        same_tokens = [bool(torch.equal(torch.argmax(a, -1),
                                        torch.argmax(b, -1)))
                       for a, b in zip(served, alone)]
        bar = 2e-4 + 3 * floor
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (errs, floor))
        ok = all(e[0] <= 2e-4 and max(e[1:]) <= 2e-4 + 3 * f
                 for e, f in got)
        rank_print(f"28 (b) {arch} at full width, {layers} layers, fp32, "
                   f"batch 1, prompt {prompt}, {TF_STEPS} decode steps, tp "
                   f"{model.size} against the card alone: max|diff| per call "
                   f"(prefill, then each step) {[f'{e:.3e}' for e in errs]}, "
                   f"floor {floor:.3e}, bars 2e-4 / {bar:.3e}; every rank "
                   f"within: {ok}; greedy tokens equal per call "
                   f"{same_tokens}; launches "
                   f"{ {k: v for k, v in n.items() if v} }; a prefill "
                   f"{tp_ms:.2f} ms at tp {model.size} against "
                   f"{alone_ms:.2f} ms on the card alone")
        check(ok, f"28 (b) {arch}: {got}")
        out[arch] = {"errs": errs, "floor": floor, "prefill_ms": tp_ms,
                     "alone_prefill_ms": alone_ms,
                     "tokens_equal": same_tokens,
                     "launches": {k: v for k, v in n.items() if v}}
        del local, served, alone, inputs, tokens
        torch.cuda.empty_cache()
    return out


def rank_tps_split_train(torch, model) -> dict:
    """recurrentgemma-2b's smoke config at TPS_SPLIT_HEADS q heads (the q
    head split at tp 4: every head on every rank): the loss and the
    gathered gradients against the card alone within TPF_SMOKE_TOL."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.launch.train import model_specs
    from repro_torch.models import attention, build
    from repro_torch.train import shardings as shr

    cfg = dataclasses.replace(tps_smoke_cfg("recurrentgemma-2b"),
                              n_heads=TPS_SPLIT_HEADS)
    check(attention.head_layout(cfg, model).split,
          "28 (b): the smoke config does not split its q heads")
    full = build(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(27))
    batch = pod_batch(torch, cfg, 0, 1, POD_LOCK_BATCH, POD_LOCK_SEQ,
                      "allreduce")
    g1, l1 = torch.func.grad_and_value(
        lambda p: build(cfg, "cuda").loss(p, batch))(full)
    specs = model_specs(cfg, model.size)
    local = shr.shard_model(full, specs, model)
    (g, loss), n = launched(torch, lambda: torch.func.grad_and_value(
        lambda p: build(cfg, "cuda", model=model).loss(p, batch))(local),
        train_counters())
    whole = shr.gather_model(g, specs, model, dst=None)
    worst = max((float((a - b).abs().max()), "/".join(map(str, path)))
                for (path, a), (_, b) in zip(shr._with_path(whole),
                                             shr._with_path(g1)))
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (abs(float(loss) - float(l1)), worst[0]))
    rank_print(f"28 (b) recurrentgemma-2b smoke at {cfg.n_heads} q heads, "
               f"tp {model.size} (the q head split): against the card alone "
               f"per rank (loss difference, the largest gradient "
               f"difference) {got}, that gradient's leaf {worst[1]} (bar "
               f"{TPF_SMOKE_TOL}); launches "
               f"{ {k: v for k, v in n.items() if v} }")
    check(all(dl <= TPF_SMOKE_TOL and dg <= TPF_SMOKE_TOL for dl, dg in got),
          f"28 (b) the q head split's gradients: {got}")
    return {"loss_diff_grad_diff": got, "worst_leaf": worst[1],
            "launches": {k: v for k, v in n.items() if v}}


def rank_tps(torch) -> dict:
    """28 (b), every rank of a world of four: phi3.5-moe-42b-a6.6b served
    at full width and depth over the model axis, every served arch
    teacher-forced against the card alone, the q head split's training."""
    from repro_torch.launch import serve

    model = serve.model_axis(TPS_SIZE)
    out = {"serve": rank_tps_serve(torch, model)}
    out["forced"] = rank_tps_forced(torch, model)
    out["split_train"] = rank_tps_split_train(torch, model)
    return out


def fleet_rank_main(role: str) -> None:
    """One rank of a 25 (c), 26 (b), 27 (b) or 28 (b) world; rank 0 prints
    the result as a FLEET line."""
    import os

    sys.path.insert(0, str(SRC))
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_fleet_mesh
    from repro_torch.train.shardings import fleet_of

    init_world("cuda")
    if role in ("tp", "tp-capture", "tpf", "tps"):
        result = {"tp": rank_tp, "tp-capture": rank_tp_capture,
                  "tpf": rank_tpf, "tps": rank_tps}[role](torch)
        rank_print(f"FLEET {json.dumps(result)}")
        dist.barrier()
        dist.destroy_process_group()
        return
    mesh = make_fleet_mesh(dist.get_world_size(), 1)
    fleet = fleet_of(mesh)
    if role == "four":
        result = {"gossip": rank_gossip(torch, fleet),
                  "mode_b": rank_mode_b(torch, fleet),
                  "gather": rank_gather(torch, fleet)}
    elif role == "family":
        result = rank_family(torch, mesh)
    else:
        result = {"capture": rank_capture(torch, fleet),
                  "trainer": rank_trainer(torch, fleet)}
    rank_print(f"FLEET {json.dumps(result)}")
    dist.barrier()
    dist.destroy_process_group()


def phase_encdec_serve(torch) -> dict:
    """14: serving seamless-m4t-large-v2 at full width (``phase_serve``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa

    n_enc = get_config(ENCDEC_ARCH).encoder_layers
    n_dec = get_config(ENCDEC_ARCH).n_layers - n_enc
    return phase_serve(
        torch, "14. serving seamless-m4t-large-v2 (encoder-decoder) at full "
        "width on the card", ENCDEC_ARCH,
        {"flash_attention": fa.flash_attention},
        {"flash_attention": n_enc + 2 * n_dec},
        f"flash in prefill once per encoder layer (non-causal, {n_enc}) and "
        f"twice per decoder layer (causal self and non-causal cross "
        f"attention, {2 * n_dec}); none in the {SERVE_GEN - 1} decode steps")


def phase_encdec_correct(torch) -> None:
    """15: the served encoder-decoder path at the smoke widths against
    the plain reference (``phase_served_correctness``)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.kernels import flash_attention as fa

    phase_served_correctness(
        torch, "15. correctness of the served encoder-decoder path",
        ENCDEC_ARCH, {"flash_attention": fa.flash_attention},
        reduce_for_smoke(get_config(ENCDEC_ARCH)), LOCK_TOL)


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import dataclasses
    import os

    # the training phases' graph pools and node-stacked copies fill most of
    # the card; segments that grow in place keep freed blocks reusable
    # (without them recurrentgemma-2b's phase 18 ran out of memory with
    # gigabytes reserved but too fragmented for a 7.3 GiB leaf)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    global cost, prof
    from repro_torch.kernels import cost
    from repro_torch.utils import profile as prof

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    t_start = time.perf_counter()
    walls = []

    def run(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls.append((label, time.perf_counter() - t0))
        print(f"-- phase {label}: {walls[-1][1]:.2f} s wall", flush=True)
        return out

    run("1", phase_device, torch)
    run("2", phase_build)
    kernels = run("3", phase_kernels, torch)
    kernels.update(run("3b", phase_attention_kernels, torch))
    kernels.update(run("3c", phase_rwkv_kernel, torch))
    kernels.update(run("3d", phase_quantize_kernels, torch))
    kernels.update(run("3e", phase_flash_backward, torch))
    kernels.update(run("3f", phase_scan_backward, torch))
    sl = run("4", phase_slice, torch)
    q8_launches = run("5", phase_compressed, torch, sl)

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.models import transformer

    kinds = transformer.layer_kinds(get_config(SERVE_ARCH))
    n_attn = sum(k in ("global", "local") for k in kinds)
    n_rec = kinds.count("rglru")
    griffin = {"flash_attention": fa.flash_attention,
               "rglru_scan": rg.rglru_scan}
    served = run("6", phase_serve, torch,
                 "6. serving slice: recurrentgemma-2b at full width on the "
                 "card", SERVE_ARCH, griffin,
                 {"flash_attention": n_attn, "rglru_scan": n_rec * SERVE_GEN},
                 f"flash once per attention layer in prefill, rglru once "
                 f"per recurrent layer in prefill and in each of "
                 f"{SERVE_GEN - 1} decode steps")
    run("7", phase_served_correctness, torch,
        "7. correctness of the served path", SERVE_ARCH, griffin,
        reduce_for_smoke(get_config(SERVE_ARCH)), TOL_RGLRU)
    n_rwkv = get_config(RWKV_ARCH).n_layers
    served_rwkv = run("8", phase_serve, torch,
                      "8. serving rwkv6-7b at full width on the card",
                      RWKV_ARCH, {"rwkv6_scan": rw.rwkv6_scan},
                      {"rwkv6_scan": n_rwkv},
                      "rwkv6_scan once per layer in prefill, none in the "
                      f"{SERVE_GEN - 1} decode steps (the one-token step is "
                      "plain torch)")
    run("9", phase_served_correctness, torch,
        "9. correctness of the served rwkv path", RWKV_ARCH,
        {"rwkv6_scan": rw.rwkv6_scan},
        dataclasses.replace(reduce_for_smoke(get_config(RWKV_ARCH)),
                            n_layers=LOCK_RWKV_LAYERS), TOL_RWKV, True)
    simulated = run("10", phase_simulated_training, torch)
    int8_run = simulated["compressed_int8"]["launches"]
    run("11", phase_train_on_trace, torch, simulated)

    # the MLA + MoE and encoder-decoder slice: every attention of their
    # prefills in the flash kernel, none in decode
    torch.cuda.empty_cache()
    print(f"\ndevice memory held before phase 12: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    flash_only = {"flash_attention": fa.flash_attention}
    n_mla = get_config(MLA_ARCH).n_layers
    served_mla = run("12", phase_serve, torch,
                     "12. serving deepseek-v2-lite-16b (MLA + MoE) at full "
                     "width on the card", MLA_ARCH, flash_only,
                     {"flash_attention": n_mla},
                     f"flash once per MLA layer in prefill ({n_mla}), none "
                     f"in the {SERVE_GEN - 1} decode steps (the absorbed "
                     f"low-rank step is plain torch)", True)
    run("13", phase_served_correctness, torch,
        "13. correctness of the served deepseek path", MLA_ARCH, flash_only,
        reduce_for_smoke(get_config(MLA_ARCH)), LOCK_TOL, True)
    served_encdec = run("14", phase_encdec_serve, torch)
    run("15", phase_encdec_correct, torch)

    # training stablelm-3b over wireless traces: every attention's forward
    # and backward in the flash kernels
    torch.cuda.empty_cache()
    print(f"\ndevice memory held before phase 16: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    trained = run("16", phase_train_lm, torch)
    run("17", phase_train_lm_lockstep, torch)

    # training the recurrent archs over wireless traces: every RG-LRU and
    # RWKV-6 scan's forward and backward, and recurrentgemma's local
    # attention, in the hand-written kernels
    torch.cuda.empty_cache()
    trained_rec = {}
    for label, arch in (("18", "recurrentgemma-2b"), ("19", "rwkv6-7b")):
        layers, batch, peak = REC_TRAIN[arch]
        trained_rec[arch] = run(label, phase_train_lm, torch, label, arch,
                                layers, REC_NODES, batch, peak)
    for label, arch in (("20a", "recurrentgemma-2b"), ("20b", "rwkv6-7b")):
        run(label, phase_train_lm_lockstep, torch, label, arch)

    # the scan trace engine: the round loop's kernel, --scale at n = 1024,
    # train-on-trace at n = 256 through it
    torch.cuda.empty_cache()
    traced = run("21", phase_trace_scan, torch)
    kernels["gossip_mix"]["w256"] = traced["w256"]

    # pod-mode training of qwen2-vl-2b: Mode A and Mode B steps, the
    # trainer, checkpoints; flash at D 128 with GQA 6:1, the rows mix
    torch.cuda.empty_cache()
    pod = run("22", phase_pod_training, torch)
    # activation checkpointing: every family's step under remat full and
    # dots against none, qwen2-vl-2b's full depth in one microbatch
    torch.cuda.empty_cache()
    remat_run = run("23", phase_remat, torch)
    # the inspection tooling: the dry run's peaks and launches and the
    # profiler's launches against what phases 8, 12 and 23 read
    torch.cuda.empty_cache()
    run("24", phase_inspection, torch, remat_run,
        {RWKV_ARCH: served_rwkv, MLA_ARCH: served_mla})
    # the node axis over a torch.distributed world: a world of one, the
    # per-rank receives of a four-rank ring, and four cards when present
    torch.cuda.empty_cache()
    fleet = run("25", phase_fleet, torch)
    # tensor parallelism over the 'model' axis: a (1, 1) world through the
    # tensor-parallel code, flash at the local head shapes, and the
    # (fleet, model) worlds when four cards are present
    torch.cuda.empty_cache()
    tp_run = run("26", phase_tp, torch)
    # tensor parallelism for every family's training: each new family
    # through the tensor-parallel code on a (1, 1) world, the scans and
    # flash at the rank's shard shapes, the (fleet, model) world when four
    # cards are present
    torch.cuda.empty_cache()
    tpf_run = run("27", phase_tpf, torch)
    # serving under tensor parallelism: every served family through the
    # tensor-parallel serving code on a (1, 1) world, flash and the scans
    # at the rank's shard shapes, the dry run's tp4 cell, and with four
    # cards phi3.5-moe-42b-a6.6b at full width over them
    torch.cuda.empty_cache()
    tps_run = run("28", phase_tps, torch)
    kernels["flash_attention"]["qwen2_vl_train"] = kernels.pop(
        "flash_attention_qwen2_vl_train")
    rec_launches = {**trained_rec["recurrentgemma-2b"]["launches"],
                    **{k: v for k, v in
                       trained_rec["rwkv6-7b"]["launches"].items()
                       if k.startswith("rwkv6")}}

    rows = []
    for name, source, replaces, launches in (
            ("gossip_mix", "gossip_mix", "gossip_mix.py:62",
             sl["launches"]["gossip_mix"]),
            ("gossip_mix_q8", "gossip_mix", "gossip_mix.py:109",
             q8_launches),
            ("flash_attention", "flash_attention", "flash_attention.py:105",
             served["launches"]["flash_attention"]),
            ("flash_attention_bwd", "flash_attention_bwd",
             "flash_attention.py:105 (no Pallas backward: the JAX package "
             "differentiates the plain chunked_attention instead)",
             trained["launches"]["flash_attention_bwd"]),
            ("rglru_scan", "rglru_scan", "rglru_scan.py:59",
             served["launches"]["rglru_scan"]),
            ("rglru_scan_bwd", "rglru_scan_bwd",
             "rglru_scan.py:59 (no Pallas backward: the JAX package "
             "differentiates the associative scan of "
             "models/rglru.py:linear_recurrence instead)",
             rec_launches["rglru_scan_bwd"]),
            ("rwkv6_scan", "rwkv6_scan", "rwkv6_scan.py:87",
             served_rwkv["launches"]["rwkv6_scan"]),
            ("rwkv6_scan_bwd", "rwkv6_scan_bwd",
             "rwkv6_scan.py:87 (no Pallas backward: the JAX package "
             "differentiates the chunked scan of models/rwkv6.py:wkv_chunked "
             "instead)", rec_launches["rwkv6_scan_bwd"]),
            ("quantize_int8_ef", "quantize", "quantize.py:53",
             int8_run["quantize_int8_ef"]),
            ("quantize_int8", "quantize", "quantize.py:53",
             int8_run["quantize_int8"]),
            ("dequantize_int8", "quantize", "quantize.py:85",
             int8_run["dequantize_int8"])):
        k = kernels[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}.cu",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "graph_ms": k.get("graph_ms"),
            "library_graph_ms": k.get("library_graph_ms"),
            "device_ms": k["device_ms"], "shape": k["shape"]})
        if "check_launches" in k:         # launches not of the main path
            rows[-1]["check_launches"] = k["check_launches"]
        if name == "flash_attention":     # each served path's own count
            rows[-1]["launches_by_path"] = {
                f"{SERVE_ARCH} (phase 6)": launches,
                f"{MLA_ARCH} (phase 12)":
                    served_mla["launches"]["flash_attention"],
                f"{ENCDEC_ARCH} (phase 14)":
                    served_encdec["launches"]["flash_attention"],
                f"{TRAIN_ARCH} training (phase 16)":
                    trained["launches"]["flash_attention"],
                "recurrentgemma-2b training (phase 18)":
                    rec_launches["flash_attention"],
                **{f"{POD_ARCH} pod training {k} (phase 22)":
                   v["flash_attention"] for k, v in pod["launches"].items()}}
        if name in ("rglru_scan", "rwkv6_scan"):   # serving and training
            rows[-1]["launches_by_path"] = {
                f"{SERVE_ARCH if name == 'rglru_scan' else RWKV_ARCH} "
                f"serving (phase {6 if name == 'rglru_scan' else 8})":
                    launches,
                f"{'recurrentgemma-2b' if name == 'rglru_scan' else RWKV_ARCH}"
                f" training (phase {18 if name == 'rglru_scan' else 19})":
                    rec_launches[name]}
        if name == "flash_attention_bwd":
            rows[-1]["launches_by_path"] = {
                f"{TRAIN_ARCH} training (phase 16)": launches,
                "recurrentgemma-2b training (phase 18)":
                    rec_launches["flash_attention_bwd"],
                **{f"{POD_ARCH} pod training {k} (phase 22)":
                   v["flash_attention_bwd"]
                   for k, v in pod["launches"].items()}}
        # flash's fp32 entry and its MLA / encoder-decoder shapes, rglru's
        # S = 1, the rows mix at W (256 x 256)
        # qwen2-vl-2b's pod-training shape (forward and backward)
        for extra in ("fp32", *NEW_FLASH_TIMED, "decode", "prefill", "w256",
                      "qwen2_vl_train"):
            if extra in k:
                rows[-1][extra] = {f: k[extra][f] for f in (
                    "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "shape")}
                for f in ("graph_ms", "library_device_ms", "library_fwd_ms"):
                    if f in k[extra]:
                        rows[-1][extra][f] = k[extra][f]
        if "library_fwd_ms" in k:         # the backward's library: SDPA's
            rows[-1]["library_fwd_ms"] = k["library_fwd_ms"]
            rows[-1]["library_device_ms"] = k["library_device_ms"]
    # phase 23's launches: (a) a step of each smoke family per remat
    # policy, (b) a step of qwen2-vl-2b's full depth per policy
    for row in rows:
        name = row["name"]
        if not name.startswith(("flash_attention", "rglru_scan",
                                "rwkv6_scan")):
            continue
        by_path = row.setdefault("launches_by_path",
                                 {"main path": row["launches"]})
        by_path.update({
            f"{arch} smoke, remat {p} (phase 23 (a))": n[name]
            for arch, res in remat_run["a"].items()
            for p, n in res["launches"].items() if n[name]})
        if name.startswith("flash_attention"):
            by_path.update({
                f"{POD_ARCH} Mode A 28 layers, {k} (phase 23 (b), a step)":
                    v["launches"][name] for k, v in remat_run["b"].items()})
    mix_row = next(r for r in rows if r["name"] == "gossip_mix")
    mix_row["launches_by_path"] = {
        "the paper run (phase 4)": mix_row["launches"],
        f"train-on-trace at n = {TRACE_TRAIN_N} (phase 21 (c))":
            traced["launches_c_mix"],
        **{f"{POD_ARCH} pod training {k} (phase 22)": v["gossip_mix"]
           for k, v in pod["launches"].items()}}
    # phase 25's runs: (a) a world of one, (b) a four-rank ring's receives
    for row in rows:
        name = {"gossip_mix": "gossip_mix", "gossip_mix_q8": "gossip_mix_q8",
                "quantize_int8_ef": "quantize_int8_ef"}.get(row["name"])
        if name is None:
            continue
        by_path = row.setdefault("launches_by_path",
                                 {"main path": row["launches"]})
        by_path.update({f"{path}, a world of one (phase 25 (a))": n[name]
                        for path, n in fleet["a"].items() if n[name]})
        by_path["a four-rank ring's per-rank receives (phase 25 (b))"] = \
            fleet["b"]["launches"][name]
    # phase 26's runs: (a) the tensor-parallel code on a world of one, (b)
    # the (fleet, model) worlds on four cards (rank 0's launches)
    twin_names = {"gossip_mix": "gossip_mix_rows",
                  "gossip_mix_q8": "gossip_mix_q8_rows"}
    for row in rows:
        name = row["name"]
        if name not in ("gossip_mix", "gossip_mix_q8", "quantize_int8_ef",
                        "flash_attention", "flash_attention_bwd"):
            continue
        by_path = row.setdefault("launches_by_path",
                                 {"main path": row["launches"]})
        by_path.update({
            f"{path}, the tensor-parallel code on a (1, 1) world "
            f"(phase 26 (a))": n[name]
            for path, n in tp_run["a"].items() if n.get(name)})
        b = tp_run.get("b")
        if b is not None:
            paths = {
                f"{TRAIN_ARCH} smoke compressed_int8 over (fleet 2, model 2)"
                f", {TP_FAMILY_ROUNDS} rounds (phase 26 (b))":
                    b["family"]["launches_by_rank"][0].get(name, 0),
                f"the pod_gossip_train twin, a step (phase 26 (b))":
                    b["twin"]["launches"].get(twin_names.get(name, name), 0),
                **{f"{POD_ARCH} Mode B {c}, 2 nodes x TP 2, "
                   f"{TP_TIMED} steps (phase 26 (b))":
                   b["mode_b"][c]["launches"].get(name, 0)
                   for c in ("none", "int8")},
                f"{TP_A_ARCH} Mode A at TP {TP_A_SIZE}, {TP_TIMED} steps "
                f"(phase 26 (b))": b["mode_a"]["launches"].get(name, 0)}
            by_path.update({k_: v for k_, v in paths.items() if v})
        if name.startswith("flash_attention"):
            row["tp_shapes"] = tp_run["flash"]
    # phase 27's runs: (a) each new family's smoke config through the
    # tensor-parallel code on a (1, 1) world, (b) the (fleet, model) world
    # on four cards (rank 0's launches)
    for row in rows:
        name = row["name"]
        if not name.startswith(("flash_attention", "rglru_scan",
                                "rwkv6_scan")):
            continue
        by_path = row.setdefault("launches_by_path",
                                 {"main path": row["launches"]})
        by_path.update({
            f"{arch} smoke, a step's loss and gradient through the "
            f"tensor-parallel code on a (1, 1) world (phase 27 (a))": n[name]
            for arch, n in tpf_run["a"].items() if n.get(name)})
        b = tpf_run.get("b")
        if b is not None:
            paths = {f"{key}, {TP_TIMED} steps (phase 27 (b))":
                     res["launches"].get(name, 0) for key, res in b.items()
                     if key not in ("family", "smoke")}
            paths["recurrentgemma-2b train-on-trace over (fleet 2, model "
                  f"2), {TPF_FAMILY_ROUNDS} rounds (phase 27 (b))"] = \
                b["family"]["launches_by_rank"][0].get(name, 0)
            paths.update({f"{key} smoke, a loss and gradient (phase 27 (b))":
                          res["launches"].get(name, 0)
                          for key, res in b["smoke"].items()})
            by_path.update({k_: v for k_, v in paths.items() if v})
        row["tpf_shapes"] = tpf_run["flash"] \
            if name.startswith("flash_attention") else tpf_run["scans"][name]
    # phase 28's runs: (a) every served family's smoke serve through the
    # tensor-parallel code on a (1, 1) world, (b) the serves over four
    # cards (rank 0's launches)
    for row in rows:
        name = row["name"]
        if name not in ("flash_attention", "rglru_scan", "rwkv6_scan"):
            continue
        by_path = row.setdefault("launches_by_path",
                                 {"main path": row["launches"]})
        by_path.update({
            f"{arch} smoke, prefill and {TPS_SMOKE_STEPS} decode steps "
            f"through the tensor-parallel serving code on a (1, 1) world "
            f"(phase 28 (a))": n[name]
            for arch, n in tps_run["a"].items() if n.get(name)})
        if tps_run["demo"].get(name):
            by_path["repro_torch.examples.serve_demo (phase 28 (a))"] = \
                tps_run["demo"][name]
        b = tps_run.get("b")
        if b is not None:
            paths = {f"{TPS_ARCH} served at full width and depth, tp "
                     f"{TPS_SIZE} (phase 28 (b))":
                     b["serve"]["launches"].get(name, 0)}
            paths.update({
                f"{arch} at full width, {TPS_TF[arch]} layers, "
                f"teacher-forced at tp {TPS_SIZE} (phase 28 (b))":
                res["launches"].get(name, 0)
                for arch, res in b["forced"].items()})
            by_path.update({k_: v for k_, v in paths.items() if v})
        row["tps_shapes"] = tps_run["flash"] \
            if name == "flash_attention" else {
                k_: v for k_, v in tps_run["scans"].items()
                if k_.startswith(name)}
    k = traced["trace_scan"]
    rows.append({
        "name": "trace_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/trace_scan.cu",
        "replaces": "src/repro/sim/jit_trace.py:123 _round_scan (no Pallas "
                    "kernel: the JAX package compiles the round loop as one "
                    "lax.scan)",
        "launches": traced["launches"]["(b) --scale"],
        "launches_by_path": traced["launches"],
        **{f: k[f] for f in (
            "max_abs_err", "max_rel_err", "ms", "device_ms", "plain_ms",
            "plain_rounds", "ms_held_rounds", "bound_ms", "bound_by",
            "library_ms", "graph_ms", "library_graph_ms", "passes",
            "decodes", "exact_decodes", "long_traces", "decide_check",
            "shape")},
        "scale": traced["scale"]})
    print("\nphase wall times: " + ", ".join(f"{label} {sec:.2f} s"
                                             for label, sec in walls))
    print(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(nvidia_smi())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fleet-rank"]:
        fleet_rank_main(sys.argv[2])
    else:
        main()
