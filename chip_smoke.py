#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

  1. card      name and power limit (``nvidia-smi``); no CUDA device or no
               ``src/repro_torch`` next to this script is an error.
  2. build     every kernel source of ``src/repro_torch/csrc`` (one nvcc
               each, all started together), with each ptxas summary and
               each library's count of tensor-core instructions (HGMMA,
               HMMA) from ``cuobjdump -sass``; the bf16 flash kernel must
               have some, every bf16 flash backward dQ and dK/dV kernel
               HGMMA and every f32 one HMMA; the bf16 backward kernels'
               registers and spills, and any ptxas line saying their
               wgmma is serialized.
  3. kernels   every MG3M grain (TB11, TB18, TB88) forced on the
               reference's kernel-test scenes and on the dgrad
               (lhs-dilated) and wgrad (rhs-dilated) plans of two strided
               scenes, and on trunk layers (TB18 on L7 and L9 at batch 1
               and 2, TB11 on L0 at batch 2, TB88 on L2 at batch 1 and L9
               at batch 8), each launch held against the grain's plain
               PyTorch version on the same operands: f32 within
               rtol=atol=1e-4, bf16 within 2e-2; each wgrad case's TB11
               and TB88 launch again with its reduction split every
               ``SPLIT_TAPS`` taps, against the plain version split alike.
  4. conv path the full-width ResNet trunk (``cnn_chain_scenes("resnet")``,
               224x224x3 in, 10 convs, ReLU between) registered on a
               ``ConvScheduler`` (strict, deadline flush), prewarmed, served
               from the background loop to ModelSession requests of batch
               1 and 2 (four alone, a burst of eight, eight of batch 1,
               then eight of batch 1 through ``serve``: one dispatch at
               bucket 8); all three grains must have launched;
               zero post-warm plan builds, no reference plans, every
               served plan's kernel held against its plain version on the
               card, one request's output held against the plain-version
               chain, and one request bitwise equal served alone and
               coalesced.
  5. conv timing  each trunk layer at buckets 1, 2, 4 and 8: its plan's
               time (CUDA events, host included), the selector's modeled
               time, and the device time (a CUDA graph of 20 calls, host
               left out) of its kernel, of every grain forced and of
               ``F.conv2d`` on the same layer (f32, TF32 off; a yardstick
               the port never calls; ``chip_tile_sweep.py`` times every
               compiled tile); then per grain at its layer of PERF.md's
               kernel table (TB11 at L0, TB18 at L2, TB88 at L1, batch 1;
               forced where the selector picks another grain there): the
               kernel, its plain version and ``F.conv2d``, device time,
               beside the kernel's bound; and a second row at the grain's
               served plan of the largest kernel time on the main path.
  6. train    the full-width ResNet trunk (``cnn_chain_scenes("resnet",
               8)``, a 10-class head) trained in f32 at a global batch of
               16 in 2 microbatches of 8: its 30 fprop/dgrad/wgrad plans
               built on a fresh registry (no reference plan), then, with
               the launch counts set to 0, one warm-up step and five
               inside a ``resolution_guard``; the loss must fall and each
               grain's launches must equal what the plans route to it
               (every direction but the first layer's dgrad, which the
               images do not need), and ``mg3m_segsum``'s what the split
               wgrad plans route to it.  Step ms (CUDA events), images/s,
               peak memory; on each microbatch, the kernels' forward
               against ``F.conv2d``'s on the same ReLU branches (within
               2e-5 of max |z| per layer, at most 1e-6 of the
               pre-activations flipping branch between the two forwards)
               and every parameter's gradient against autograd of the
               same network on ``F.conv2d`` (TF32 off) on those branches
               within 2e-4 of max |g|, and the step's gradient norm
               against the norm of the oracle's mean over the
               microbatches within 2e-4; each (layer, direction) plan's kernel
               against its plain version (the first layer's dgrad too; a
               wgrad plan's split reduction, S and its second pass
               printed, against the plain version split alike), then its
               device time beside the plan's, the bound and the PyTorch
               call for the same function (``F.conv2d``,
               ``conv2d_input``, ``conv2d_weight``); ``mg3m_segsum`` on
               every split wgrad plan's partials (S = 98 down to 2),
               bitwise its plain version in f32 and bf16, beside
               ``torch.sum`` and its bound; the `oc:4` L0 wgrad shard
               beside the whole scene, unsplit and split; and the small-CNN
               launcher ``python -m repro_torch.launch.train_cnn
               --check-loss`` run in-process on the card.
  7. tune     ``repro_torch.tune`` on the card: the trunk's 10 fprop
               scenes at buckets 1, 2, 4 and 8 and the train step's 19
               dgrad/wgrad exec scenes (batch 8; the first layer's dgrad,
               never launched, left out), each exact (no proxy caps) through
               ``autotune_scene`` (top 4 of the analytic ranking, device
               time of 5 replays of a 3-execute CUDA graph) into a fresh
               ``ScheduleCache``, no measurement allowed to fail; a
               calibration fitted to the cache, saved and reloaded (median
               relative error per class before -> after).  Then a second
               ``ConvScheduler`` over the same trunk and weights under
               ``policy="tuned"``: every plan a tune-cache hit, the same
               requests at each bucket bitwise equal to the analytic
               session's, no measurement, plan build or resolution while
               serving, trunk kernel device time per bucket beside the
               analytic plans'; and phase 6's trainer under
               ``policy="tuned"``: its losses bitwise equal to phase 6's,
               step ms of both (interleaved), wgrad kernel ms per layer of
               both.  The tune cache and the calibration live in a
               temporary directory (``REPRO_TORCH_TUNE_CACHE``,
               ``REPRO_TORCH_CALIBRATION``, set before the port is
               imported and removed at exit), so no artifact of an earlier
               run changes this run's picks; phases 3-6 run under the
               analytic model.
  8. LM kernels  causal_conv1d on tests/test_kernels.py's shapes and flash
               attention on tests/test_flash_kernel.py's (causal and not,
               plus D = 112, and all of them again at D = 128), both also
               at the LM path's shapes, and flash at the dense path's
               (q (32, 2048, 128), k/v (4, 2048, 128), causal), f32 and
               bf16, each held against its
               plain version: f32 within 1e-4 (conv) / 2e-4 (attention),
               bf16 within 2e-2; flash's f32 kernel on FLASH_SHAPES also
               within ``XTF32_TOL`` of ``flash_attention_3xtf32_plain``,
               bitwise from run to run and with its log-sum-exp.
               causal_conv1d's backward kernels
               (``causal_conv1d_bwd``) on the conv shapes, f32 and bf16,
               run twice and bitwise equal, bitwise
               ``causal_conv1d_bwd_plain``, and within 2e-4 / 2e-2 of max
               |g| of ``F.conv1d``'s autograd gradients (TF32 off).
               Flash's backward kernels
               (``flash_attention_bwd``) on ``FLASH_BWD_SHAPES`` (D = 112,
               a group of 8, a ragged S; causal and not), f32 and bf16,
               against ``flash_attention_bwd_plain`` within 2e-4 / 2e-2 of
               max |g|, the f32 kernels also within ``XTF32_BWD_TOL`` of
               ``flash_attention_bwd_3xtf32_plain``, the bf16 ones within
               ``XBF16_BWD_TOL`` of ``flash_attention_bwd_bf16_plain``,
               each run twice and bitwise equal, and a sequence's
               gradients bitwise alone and in a batch of 3 (both dtypes,
               ``flash_bwd_batch_check``); the forward's
               ``o`` with its log-sum-exp bitwise the ``o`` without it,
               and the log-sum-exp within ``LSE_TOL`` (1e-5 f32, 4e-3
               bf16) of the plain version's.  Then each backward
               kernel's device time by name under ``torch.profiler``
               (``flash_bwd_split``, the process's first profiler
               session): f32 at ``train_lm``'s and the training shape,
               for phase 16's row; bf16 at the training shape and
               zamba2-7b's, for phase 14's.
  9. LM path   full-width zamba2-7b (81 layers, d_model 3584, 32x112
               heads, bf16, seeded random weights) on the card: the
               reference's cross-form oracle (prefill(255) + decode_step ==
               forward(256) at the last position, within a bf16 tolerance
               relative to max |logit|); then, with the launch counts set to
               0, ``prefill`` of 2 x 2048 tokens and a ``ServeEngine`` (2
               slots) answering 4 greedy requests (prompts of 17, 64, 255
               and 600 tokens, 16 new each, one joining mid-stream); both
               kernels must have launched on it; the joining request's
               neighbour must give the tokens it gives served alone; the
               reduced config's prefill on the card must match the CPU's;
               one decode step and one prefill under ``torch.profiler``
               (device busy time, idle share, time by kernel class).
 10. attention LM path  the attention-block families on the card.
               Full-width qwen2.5-3b (36 layers, d_model 2048, 16x128
               heads over 2 kv heads, vocab 151936, tied head, QKV bias,
               bf16, seeded weights): the cross-form oracle; then, with
               the launch counts set to 0, a 2 x 2048 prefill and a
               2-slot ``ServeEngine`` on 4 greedy requests of phase 9's
               lengths (17, 64, 255 and 600 tokens: 512 of the 600
               prefilled, the rest decoded; 16 new each, one joining);
               flash must have launched; the isolation check;
               the decode step at 2 slots (median of 11, CUDA events), the
               f32 head's device time in it, and the two profiles.
               grok-1-314b at full width with its depth cut to 2 layers
               (the 64 are 633 GB): the oracle drop-free (capacity factor
               E/k), a 1 x 2048 prefill at the config's 1.25 with its
               drop fraction per layer printed (not gated), and a 2-slot
               ``ServeEngine`` on 2 requests with the isolation check.
               musicgen-large at full width (embeddings in, LayerNorm,
               GELU, sinusoidal positions, 32x64 heads): the oracle on
               seeded embeddings.  Reduced qwen3-14b and arctic-480b
               (f32): the card's prefill logits within 1e-3 of the CPU's.
 11. ssm LM path  full-width rwkv6-3b (32 layers, d_model 2560, 40 heads
               of 64, d_ff 8960, vocab 65536, LayerNorm, bf16, seeded
               weights; no TPU kernel: the reference computes rwkv6 in
               plain JAX): the cross-form oracle (prefill(255) runs the
               scan, forward(256) the chunked time-mix) on an f32 copy of
               the weights within ``SSM_F32_TOL`` (1e-2), and in bf16 on
               the model's first 4 layers within ``ORACLE_TOL``, both with
               the argmax agreeing; in bf16 at 8, 16 and 32 layers
               measured and not gated (``SSM_DEPTHS``'s note);
               on layer 0 the
               chunked time-mix against the scan over 256 tokens in f32
               (within 5e-4 of max |y|); a 2 x 2048 prefill (chunked) and
               a 2-slot ``ServeEngine`` on phase 9's 4 prompts (the
               longest multiple of 64 prefilled, the rest decoded; one
               joining) with the isolation check; the decode step at 2
               slots (median of 11) and two profiles.
 12. LM timing  per kernel at the LM path's shapes: the kernel, its plain
               version and one PyTorch call computing the same function
               (``F.conv1d``, ``F.scaled_dot_product_attention``; never
               called by the port), beside the kernel's bound; the flash
               kernels' D = 128 instance at q (64, 2048, 128) bf16
               causal, reported as the ``d128`` entry of the
               ``flash_attention_fwd`` row; and the row
               ``flash_attention_fwd_dense_path`` at qwen2.5-3b's prefill
               shape, q (32, 2048, 128), k/v (4, 2048, 128), its launches
               those of phase 10's main path.
 13. LM train  full-width qwen2.5-3b trained through
               ``train.step.build_train_step``: seq 4096 (train_4k's),
               global batch 2 in 2 microbatches of 1 (train_4k's 256, cut
               for one card), AdamW with f32 moments, every layer
               checkpointed.  First, at the training path's flash shape
               (q (16, 4096, 128), k/v (2, 4096, 128), causal, f32 and
               bf16), the kernel against its plain version,
               ``flash_attention_bwd`` (the backward kernels) against
               ``flash_attention_bwd_plain`` within 2e-4 (f32) / 2e-2
               (bf16) of max |g| (bf16 also within ``XBF16_BWD_TOL`` of
               ``flash_attention_bwd_bf16_plain``) and bitwise from run
               to run, and
               ``FlashAttention``'s backward against autograd of the plain
               version; the backward kernels held the same way (the
               log-sum-exp too) at zamba2-7b's training shape (q (32,
               4096, 112), g = 1, bf16) and ``train_lm``'s (q (32, 256,
               64), k/v (16, 256, 64), f32), both causal.  Then, with the
               launch counts set to 0, a
               gradient-only step (every parameter's gradient finite and
               nonzero), a warm-up step and 3 timed steps on one fixed
               batch: the loss must be finite, end below where it
               started and, after the warm-up, reach at least
               ``LM_TRAIN_FALL`` below it, flash must launch 2 x 36 times
               per microbatch (forward and recomputation) and its
               backward run 36 times, each launching the backward
               kernels once; step ms (CUDA events), tokens/s and
               peak memory.  Before it, zamba2-7b at full width with its
               depth cut to one group (6 Mamba2 layers and the shared
               attention block; the 81 layers do not fit with the
               moments), trained
               the same way with the counts set to 0: a gradient-only step
               (every gradient finite and nonzero) and one update step;
               causal_conv1d must launch 2 x 6 times per microbatch and
               its backward run 6 times, launching its backward kernels
               once each; flash's backward kernels once per
               ``FlashAttention`` backward.
 14. LM gradient oracle  reduced qwen2.5-3b, zamba2-7b and rwkv6-3b (f32):
               one train step (2 microbatches of 1 x 64 tokens) on the
               card and on the CPU from the same weights; gradients within
               1e-4 of max |g| per leaf, parameters after the update
               within 1e-4 where the gradient's sign is fixed (within
               2 lr elsewhere); both kernels' backward must have run on
               the card, each through its kernels once per backward.
               Then the training path's kernel rows: flash at the
               training shape (launches from phase 13), the backward
               kernels' row ``flash_attention_bwd_train_path`` at the same
               shape (device ms, plain, bound, SDPA's backward as the
               library, by graph replay and held to the plain version,
               ``flash_attention_vjp``'s recomputation as
               ``recompute_ms``, phase 13's launches, the backward
               kernels' HGMMA/HMMA counts, phase 8's per-kernel split:
               dQ, dK/dV and the second pass), causal_conv1d at zamba2-7b's
               training shape (x [1, 4096, 7296] bf16; launches from
               phase 13's zamba2-7b steps), and its backward kernels' row
               ``causal_conv1d_bwd_train_path``: held as in phase 8 at
               that shape and at a TP shard's [2, 2048, 1920] in f32 and
               bf16, then device ms (both passes), plain, bound,
               ``F.conv1d``'s backward by graph replay (its forward and
               backward less its forward), the TP shard's ms, and phase
               13's launches.
 15. analyze  ``repro_torch.launch.analyze`` on the card over the six
               paper CNNs' uncapped fprop/dgrad/wgrad scenes (every
               feasible (schedule, blocking, tile) point verified
               statically for this card's SMs and shared memory; the
               card's own ``in_coord``, ``mg3m_in_coord_table``, equal to
               the verifier's expected table bit for bit on every swept
               exec scene; lint over ``src/repro_torch``), then
               ``verify_plan`` on every plan of phases 4-7 (the served
               trunk at buckets 1-8, the 30 training plans, the tuned
               plans) and the card's ``in_coord`` on their exec scenes: 0
               error findings.  For each compiled tile instance the plans
               launch, its registers and the card's blocks per SM
               (``mg3m_tile_attributes``) beside ``blocks_per_sm``'s;
               ``occupancy-overestimate`` warnings counted, not gated.
 16. examples  ``repro_torch.examples.serve_lm`` at its defaults, and
               ``train_lm --steps 20`` then the same run resumed from its
               step-10 checkpoint alone: the resumed losses bitwise equal
               to the uninterrupted run's.  Their reduced f32 models run
               the f32 flash kernel, which each must launch: the
               ``flash_attention_fwd_f32`` and ``flash_attention_bwd_f32``
               rows (kernels, plain versions, SDPA in f32, bounds at the
               f32 FMA and three-term TF32 rates) at ``train_lm``'s shape
               and the training path's, the kernels held to both plain
               versions, their launches counted from 0 over the two
               ``train_lm`` runs (``serve_lm``'s printed apart), where the
               backward kernels must launch once per ``FlashAttention``
               backward.  Then the four conv
               examples at their defaults, the MG3M launch counts set to 0
               before each and read after: ``quickstart``, ``serve_conv``
               (its plan artifact in the temporary directory),
               ``mg3m_cnn`` (launches in each of fprop, dgrad and wgrad,
               attributed per ``ConvPlan.execute``; then one step from its
               start, loss and every gradient through the plans, against
               autograd on ``F.conv2d`` on the kernels' ReLU branches,
               gradients within ``GRAD_TOL``) and ``serve_cnn`` (alexnet
               and resnet at the paper's widths, 3 layers each, buckets
               1-8, with its parity and steady-state checks; then every
               served layer's plan at every rung against
               ``kernels.ref.conv_ref`` within 1e-4 of max |ref|),
               each launching at least one MG3M kernel; around
               ``serve_cnn`` a fresh default ``MetricRegistry`` and an
               enabled default ``Tracer``, its scheduler's metrics (with
               the drift snapshot) dumped and the trace exported, both
               read by ``launch.obsreport.build_report``: the report's
               deadline requests and sheds equal the scheduler's
               ``stats()``, and it has a ``layers`` entry for every served
               layer.
 17. shard    ``repro_torch.shard`` on a ring of 4 x this card
               (``(cuda:0,) * 4``) over the full-width ResNet trunk:
               every layer at bucket 8, every op (fprop, dgrad, wgrad) and
               every axis feasible at n = 4 pinned (the selector's grain for
               the sub-scene) and held against the one-device plan on the
               same operands, batch/oc/h bitwise and ic within
               rtol=atol=1e-4, with the blocked (layer, op, axis) printed and
               a grain no sub-scene picks forced where it fits; then, with
               the launch counts set to 0, ``ConvServer(mesh=make_mesh_for(
               4, 1, devices=ring))`` over the trunk's layers at buckets
               1-8 (strict) bitwise equal to the one-device server, 0 plan
               misses and builds after prewarm, the partition of each
               (layer, bucket) printed (when the selector keeps all of
               them unsharded, a second mesh server prewarmed from an
               artifact of pinned ``batch:4`` plans too), and
               ``make_model_plans(trunk, devices=ring)`` trained 3 steps by
               phase 6's trainer, losses within 1e-4 of a one-device run's
               and each grain's launches equal to the plans' routing;
               ``verify_sharded_plan`` on every sharded plan: 0 errors; per
               layer the ``batch:4`` and one-device dispatch times at
               bucket 8 (CUDA events, host included) and the shards'
               kernels' device time, from which the ring's launch overhead
               and one copy's time (``core.mapping``'s
               ``SHARD_LAUNCH_OVERHEAD_S`` and ``ICI_LATENCY_S``) are read.
               No speed is claimed: the four shards share one card.
 18. train profiles  one more train step of phase 6, then one of phase
               13's run rebuilt from its seed after one warm-up step, each
               under ``torch.profiler`` (device busy time and idle share),
               after every timed phase (phase 19 runs before them), since
               no timed phase should run after a profiler session.
 19. LM mesh  ``parallel/ring.py`` on rings of this card (``(cuda:0,) *
               n``; no speed is claimed, the shards share one card).  It
               runs after phase 17 and before phase 18's profiles; phase
               13's state is dropped first (a ring's and it do not fit on
               the card together), and phase 18 rebuilds the run it
               profiles.  Its times are CUDA events.  With the launch
               counts set to 0
               around each ring's run: full-width qwen2.5-3b (bf16, seq
               4096) in the DP grain on a (2, 2) ring, 3 steps at global
               batch 4, losses, gradient norms and every parameter and moment
               bitwise the one-device step's (4 microbatches of 1), ms per
               step of
               both (the ring's host cost their difference), peak memory,
               the ``repro.mesh.*`` collective bytes per step; qwen3-14b
               at full width with its depth cut from 40 to 4 layers in the
               TP + SP grain on a (2, 2) ring, 3 steps, losses within
               ``TP_LOSS_TOL`` and gradient norms within ``TP_NORM_TOL``
               relative of one device's (bf16 partial sums), flash
               launched at the shard's 20 q heads over 4 k/v heads (64 per
               step), and a reduced f32 copy's gradients within 1e-4 of
               max |g| of one device's (its update within 1e-4 where the
               gradient's sign is fixed); qwen2.5-3b served on a (1, 2)
               ring (head-sharded cache) and a (1, 4) ring
               (sequence-sharded), a 2 x 2048 prefill and 8 decode steps
               within ``ORACLE_TOL`` of max |logit| of one device's, and a
               reduced f32 copy within 1e-4; elastic restore of
               qwen2.5-3b at full width with its depth cut to 2 layers,
               (2, 2) -> (4, 1) -> (1, 1), bitwise; then the flash kernel
               at the TP shard shape (q (20, 4096, 128), k/v (4, 4096,
               128)): the ``flash_attention_fwd_tp_shard`` row.
 19b. attention families on a mesh  ``parallel/ring.py``'s moe, vlm
               and audio paths on rings of this card, right after phase
               19, each ring against one device, the ``repro.mesh.*``
               bytes of every ring step against the dry run's model of it
               (one representative position of a ``meta`` ring, times the
               chips: they must be equal): grok-1-314b at full width, its
               depth cut to ``MOE_LAYERS``, served on a (1, 8) ring (one
               expert per shard, head-sharded cache) and a (1, 16) ring
               (TP inside the experts, the production mesh's grain;
               sequence-sharded cache), a 2 x 2048 prefill and 8 decode
               steps drop-free, the rings fed the one-device run's greedy
               tokens, logits within ``MESH_TOL`` (2e-2) of max |logit|;
               musicgen-large uncut (48 layers) served on (1, 4) on seeded
               bf16 embeddings the same way; llava-next-mistral-7b at full
               width, its depth cut to ``VLM_LAYERS``, trained in the TP +
               SP grain on (2, 2), 3 steps at global batch 4 x 4096 of
               seeded bf16 embeddings, losses within ``TP_LOSS_TOL`` and
               gradient norms within ``TP_NORM_TOL`` relative of one
               device's; reduced grok-1-314b and arctic-480b (f32) at
               capacity factor 1.25 on a (2, 2) DP ring and a (1, 2) EP
               ring, each microbatch routed as one set, loss and
               gradients within 1e-4 of the one-device step's; then the
               flash kernel at the (1, 16) grok shard's prefill shape
               (q (6, 2048, 128), k/v (2, 2048, 128)): the
               ``flash_attention_fwd_moe_shard`` row.
 20. dry run and roofline  traced on the meta device, last so that no
               timed phase shares the host with it: qwen2.5-3b's train
               step (phase 13's seq 4096, batch 2 in 2 microbatches), its
               2 x 2048 prefill and its decode step at 2 slots (phase 10):
               predicted argument bytes and peak beside what the card
               allocated there; the traced bound (``launch.roofline``:
               FLOPs by dtype over the datasheet's peaks, bytes over
               3.35 TB/s) and the model's own bound (its config's FLOPs
               and unavoidable bytes) beside the measured time; the
               measured fraction (traced bound / time), the model fraction
               (model bound / time) and ``roofline_fraction`` must lie in
               (0, 1.05].  The dry run's model of phase 19's two train
               rings (one representative position of a (2, 2) ``meta``
               ring): its collective bytes per step must equal the
               counters measured there; its per-chip peak times 4 beside
               the card's.  Then one JSON line per (arch x shape) cell of
               the full-size grid, traced in one process per CPU core (at
               most 8), ``fits`` against this card's memory; the grid's
               cells and the three steps' rooflines rendered as
               ``launch.make_experiments``' tables.

In the ``kernels`` line, ``ms`` and ``library_ms`` are device time (20
calls replayed from a CUDA graph, the host's time per call left out);
``plain_ms`` is CUDA-event time of 20 back-to-back calls (of the one
checking call on the ``_train_path`` rows), the host's time included.

The last three lines of output are the ``kernels`` JSON line (all five
kernels, flash twice; each conv grain has a second row,
``<name>_main_path``, and each
grain the train step launches a row ``<name>_train_path`` at its longest
plan of the step; flash and causal_conv1d have ``<name>_train_path`` rows
from phases 13 and 14 (causal_conv1d's with ``backward_ms``), and the
backward kernels the row ``flash_attention_bwd_train_path``; flash's f32
kernels the rows
``flash_attention_fwd_f32`` and ``flash_attention_bwd_f32`` from phase 16;
each conv grain a row
``<name>_shard_path`` from phase 17 at its longest sub-scene launch of the
forced partitions, its launches those of phase 17's sharded serving and
training; flash a row ``flash_attention_fwd_tp_shard`` from phase 19 at
the TP shard shape, its launches those of the TP ring's steps, and a row
``flash_attention_fwd_moe_shard`` from phase 19b at the (1, 16) grok
shard's prefill shape, its launches those of that ring's serving), the
card's name and power limit, and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"


KERNEL_SOURCE = "src/repro_torch/csrc/mg3m_conv.cu"
SOURCES = ("mg3m_conv.cu", "causal_conv1d.cu", "flash_attention.cu")
REPLACES = {"TB11": "src/repro/kernels/mg3m_conv.py:288",
            "TB18": "src/repro/kernels/mg3m_conv.py:320",
            "TB88": "src/repro/kernels/mg3m_conv.py:352"}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# (B, IC, OC, inHW, flt, pad, std): tests/test_kernels.py's sweep
KERNEL_SCENES = [(8, 16, 24, 10, 3, 1, 1), (4, 8, 8, 7, 1, 0, 1),
                 (16, 32, 48, 12, 5, 2, 2), (3, 5, 7, 9, 3, 0, 2),
                 (1, 1, 1, 4, 3, 1, 1), (2, 64, 16, 8, 3, 1, 1),
                 (128, 16, 8, 6, 2, 0, 2)]
# (B, IC, OC, inH, inW, flt, pad, stdH, stdW): tests/test_dilated.py's
# "stride2" and "asym_stride"
STRIDED_SCENES = [(2, 8, 4, 10, 10, 3, 1, 2, 2), (3, 5, 7, 11, 9, 3, 0, 3, 2)]
# (grain, layer, batch) forced on the trunk in the kernel phase: TB18's
# small-spatial layers at batch 1 and 2, TB11 on the stem, TB88 on a
# batch-1 (column-major) and a batch-8 (k-major) layer
TRUNK_CASES = [("TB18", "resnet/L7", 1), ("TB18", "resnet/L7", 2),
               ("TB18", "resnet/L9", 1), ("TB18", "resnet/L9", 2),
               ("TB11", "resnet/L0", 2), ("TB88", "resnet/L2", 1),
               ("TB88", "resnet/L9", 8)]
# PERF.md's per-grain timing layers (batch 1)
TIMING_LAYERS = {"TB11": "resnet/L0", "TB18": "resnet/L2",
                 "TB88": "resnet/L1"}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """Registers per thread and spill bytes over every compiled kernel,
    from the ``-Xptxas -v`` report."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
    if not regs:
        return "no report"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers per "
            f"thread, spill stores {min(spills, default=0)}-"
            f"{max(spills, default=0)} bytes")


def tensor_core_counts(lib_path) -> dict:
    """``{function: (HGMMA, HMMA)}`` instruction counts of one built
    library, from ``cuobjdump -sass`` (the toolkit's, next to nvcc)."""
    from repro_torch.kernels import cuda_build
    tool = Path(cuda_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        counts[name] = (part.count("HGMMA"), part.count("HMMA"))
    return counts


def check_f32_bwd_hmma(counts: dict) -> dict:
    """The f32 flash backward's dQ and dK/dV kernels among ``counts``
    (``tensor_core_counts``): one of each per head dim, every one issuing
    HMMA (its products on the tensor cores); returns them."""
    f32 = {n: c for n, c in counts.items()
           if "flash_bwd_dq_kernel" in n or "flash_bwd_dkdv_kernel" in n}
    if len(f32) != 10 or not all(c[1] for c in f32.values()):
        raise AssertionError(f"the f32 flash backward kernels issue no "
                             f"HMMA: {f32}")
    return f32


def check_bf16_bwd_hgmma(counts: dict) -> dict:
    """The bf16 flash backward's dQ and dK/dV kernels among ``counts``
    (``tensor_core_counts``): one of each per head dim, every one issuing
    HGMMA (its products on wgmma); returns them."""
    bf16 = {n: c for n, c in counts.items()
            if "flash_bwd_dq_bf16_kernel" in n
            or "flash_bwd_dkdv_bf16_kernel" in n}
    if len(bf16) != 10 or not all(c[0] for c in bf16.values()):
        raise AssertionError(f"the bf16 flash backward kernels issue no "
                             f"HGMMA: {bf16}")
    return bf16


def ptxas_kernels(log: str, part: str) -> dict:
    """``{function: (registers, spill store bytes)}`` of the compiled
    kernels whose name holds ``part``, from the ``-Xptxas -v`` report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
        elif name and part in name:
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores", line)
            r, sp = out.get(name, (0, 0))
            out[name] = (int(regs.group(1)) if regs else r,
                         int(spill.group(1)) if spill else sp)
    return out


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` back-to-back calls,
    CUDA events around the run, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``: ``iters`` calls
    captured in one CUDA graph and replayed between two CUDA events, so
    the host's time per call, longer than a small conv kernel's own, is
    left out (``time_ms`` of back-to-back calls reads it instead)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up, outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# taps per segment forced on the kernel phase's wgrad cases (the plans of
# these small scenes do not split): TB11's and TB88's split launches on
# every scene, TB11's resident filter fitting at these lengths
SPLIT_TAPS = (2, 5)


def kernel_phase(torch, errs):
    """Force every grain on the test scenes; hold each launch against the
    plain version on the same operands (a split launch against the plain
    version split alike), and each wgrad case's TB11/TB88 launch again at
    ``SPLIT_TAPS``.  Returns the number of checks."""
    from repro_torch.core.scene import ConvScene
    from repro_torch.kernels.mg3m_conv import conv_plain
    from repro_torch.models.cnn import cnn_chain_scenes
    from repro_torch.plan import ConvOp, make_plan

    chain = cnn_chain_scenes("resnet")
    gen = torch.Generator().manual_seed(0)
    checks = 0
    for dtype, tol in TOL.items():
        tdt = getattr(torch, dtype)

        def rand(shape):
            return torch.randn(shape, generator=gen).to("cuda", tdt)

        cases = []
        for b, ic, oc, hw, f, pad, std in KERNEL_SCENES:
            sc = ConvScene(B=b, IC=ic, OC=oc, inH=hw, inW=hw, fltH=f, fltW=f,
                           padH=pad, padW=pad, stdH=std, stdW=std,
                           dtype=dtype)
            cases.append((sc, ConvOp.FPROP, rand(sc.in_shape()),
                          rand(sc.flt_shape())))
        for b, ic, oc, h, w, f, pad, sh, sw in STRIDED_SCENES:
            sc = ConvScene(B=b, IC=ic, OC=oc, inH=h, inW=w, fltH=f, fltW=f,
                           padH=pad, padW=pad, stdH=sh, stdW=sw, dtype=dtype)
            x, flt, cot = (rand(sc.in_shape()), rand(sc.flt_shape()),
                           rand(sc.out_shape()))
            cases.append((sc, ConvOp.DGRAD, cot, flt))
            cases.append((sc, ConvOp.WGRAD, x, cot))
        grains = [("TB11", "TB18", "TB88")] * len(cases)
        for grain, name, b in TRUNK_CASES:
            sc = ConvScene(**{**chain[name].with_batch(b).__dict__,
                              "dtype": dtype})
            fan_in = sc.fltH * sc.fltW * sc.IC
            cases.append((sc, ConvOp.FPROP, rand(sc.in_shape()),
                          rand(sc.flt_shape()) * fan_in ** -0.5))
            grains.append((grain,))
        for (sc, op, a, b), names in zip(cases, grains):
            for grain in names:
                try:
                    plan = make_plan(sc, op, policy=grain)
                except ValueError:
                    continue     # the grain does not fit this scene
                fn, inp, flt, blocks = plan.kernel_call(a, b)
                es = plan.exec_scene
                splits = [plan.seg_taps]
                if op is ConvOp.WGRAD and grain != "TB18":
                    splits += [s for s in SPLIT_TAPS
                               if s < es.fltH * es.fltW]
                for seg in splits:
                    got = fn(inp, flt, es,
                             **dict(blocks, **({"seg_taps": seg} if seg
                                               else {}))).float()
                    want = conv_plain(inp, flt, es, seg).float()
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    if not torch.allclose(got, want, rtol=tol, atol=tol):
                        raise AssertionError(
                            f"{grain} {op.value} {dtype} (split every {seg} "
                            f"taps) disagrees with its plain version (max "
                            f"abs err {err}) on {es.describe()}")
                    errs[(grain, dtype)] = max(errs.get((grain, dtype),
                                                        0.0), err)
                    checks += 1
                # the plan's own execute runs the same launch end to end
                plan.execute(a, b)
    torch.cuda.synchronize()
    return checks


def he_weights(torch, chain):
    """He-scaled seeded weights, so activations stay O(1) through the
    ReLU trunk."""
    gen = torch.Generator().manual_seed(1)
    return {name: torch.randn(sc.flt_shape(), generator=gen)
            * (2.0 / (sc.fltH * sc.fltW * sc.IC)) ** 0.5
            for name, sc in chain.items()}


def main_path(torch, np, errs):
    from repro_torch.kernels import mg3m_conv as K
    from repro_torch.kernels.mg3m_conv import conv_plain
    from repro_torch.models.cnn import cnn_chain_scenes
    from repro_torch.plan import ConvOp
    from repro_torch.serve.sched import ConvScheduler, SchedConfig

    chain = cnn_chain_scenes("resnet")
    sched = ConvScheduler(max_batch=8, strict=True,
                          config=SchedConfig(max_gather_s=0.005,
                                             flush_margin_s=0.002))
    weights = he_weights(torch, chain)
    sched.register_net("resnet", chain, weights, activation=torch.relu)
    t0 = time.perf_counter()
    built = sched.prewarm(compile=True)
    prewarm_s = time.perf_counter() - t0
    sc0 = chain["resnet/L0"]
    gen = torch.Generator().manual_seed(2)
    sess = sched.session("resnet")

    snap = sched.snapshot()
    K.reset_launch_counts()
    sched.start()
    lat, reqs = [], []
    try:
        # four requests one at a time (deadline flushes at small buckets),
        # then a burst of eight that coalesces
        for i in range(4):
            x = torch.randn(sc0.in_shape()[:3] + (1 + i % 2,), generator=gen)
            t = time.perf_counter()
            r = sess.submit(x, deadline_s=0.05)
            sched.wait([r])
            lat.append(time.perf_counter() - t)
            reqs.append(r)
        burst = []
        for i in range(8):
            x = torch.randn(sc0.in_shape()[:3] + (1 + i % 2,), generator=gen)
            burst.append((time.perf_counter(),
                          sess.submit(x, deadline_s=0.1)))
        for t, r in burst:
            sched.wait([r])
            lat.append(time.perf_counter() - t)
            reqs.append(r)
        # eight requests of batch 1 submitted back to back: bucket 8,
        # where the selector picks TB88 on several layers
        xs = [torch.randn(sc0.in_shape()[:3] + (1,), generator=gen)
              for _ in range(8)]
        burst = [(time.perf_counter(), sess.submit(x, deadline_s=0.1))
                 for x in xs]
        for t, r in burst:
            sched.wait([r])
            lat.append(time.perf_counter() - t)
            reqs.append(r)
    finally:
        sched.stop()
    # and eight of batch 1 through ``serve`` with the loop stopped: one
    # coalesced dispatch at bucket 8 whatever the timing of the bursts
    xs8 = [torch.randn(sc0.in_shape()[:3] + (1,), generator=gen)
           for _ in range(8)]
    t = time.perf_counter()
    outs8 = sess.serve(xs8)
    lat.append(time.perf_counter() - t)
    counts = K.launch_counts()
    stats = sched.stats(since=snap)

    if stats["plan_misses"] or stats["plan_builds"]:
        raise AssertionError(f"post-warm plan misses/builds: {stats}")
    plans = sched.registry.plans().values()
    if any(p.uses_reference for p in plans):
        raise AssertionError("a served plan runs the torch reference")
    if stats["requests"] != len(reqs) + len(xs8):
        raise AssertionError(f"served {stats['requests']} of "
                             f"{len(reqs) + len(xs8)}")

    grains = {}
    for name, sc in chain.items():
        grains[name] = {b: sched.registry.get(sc.with_batch(b), ConvOp.FPROP)
                        .schedule for b in sched.flush_ladders()[name]}
    for grain in ("TB11", "TB18", "TB88"):
        if counts[grain] == 0:
            raise AssertionError(f"{grain} never launched on the main "
                                 f"path: {counts}")
    # every served plan's kernel against its plain version, at the shapes
    # the main path gave it (after the counts were read)
    gen = torch.Generator().manual_seed(5)
    for plan in plans:
        x = torch.randn(plan.scene.in_shape(), generator=gen).cuda()
        w = sched._layers[_layer_of(chain, plan.scene)].flt
        fn, inp, flt, blocks = plan.kernel_call(x, w)
        got = fn(inp, flt, plan.exec_scene, **blocks)
        want = conv_plain(inp, flt, plan.exec_scene)
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=TOL["float32"],
                              atol=TOL["float32"]):
            raise AssertionError(f"{plan.describe()} disagrees with its "
                                 f"plain version (max abs err {err})")
        key = (plan.schedule, "float32")
        errs[key] = max(errs.get(key, 0.0), err)

    # correctness: one request against the plain-version chain on the card
    req = reqs[0]
    z = req.x.float()
    for name, sc in chain.items():
        zp = torch.nn.functional.pad(z, (0, 0, 0, 0, sc.padW, sc.padW,
                                         sc.padH, sc.padH))
        z = torch.relu(conv_plain(zp, sched._layers[name].flt,
                                  sc.with_batch(z.shape[3])))
    out = req.out
    last = list(chain.values())[-1]
    if tuple(out.shape) != last.out_shape()[:3] + (req._b,):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite output")
    rel = ((out - z).abs().max() / z.abs().max().clamp_min(1e-30)).item()
    if rel > 1e-4:
        raise AssertionError(f"session output vs plain chain: rel err {rel}")
    # a request of the bucket-8 dispatch served again alone (bucket 1,
    # other grains) is bitwise what it was coalesced: every kernel sums
    # tap-major, k ascending, whatever the batch, grain or tile
    alone = sess.serve([xs8[-1]])[0]
    if not torch.equal(alone, outs8[-1]):
        raise AssertionError("a request served alone differs bitwise from "
                             "the same request served coalesced")

    ms = np.asarray(lat) * 1e3
    print(f"main path: {stats['requests']} requests, {stats['dispatches']} "
          f"dispatches, prewarm {prewarm_s:.3f} s ({built} plans), "
          f"p50 {np.percentile(ms, 50):.3f} ms, p99 "
          f"{np.percentile(ms, 99):.3f} ms, deadline misses "
          f"{stats['deadline_misses']}, rel err vs plain chain {rel:.3e}")
    for name, by_bucket in grains.items():
        print(f"  {name} {chain[name].describe()[:60]} grain by bucket "
              f"{by_bucket}")
    print(f"  launches on the main path: {counts}; {len(plans)} served "
          f"plans held against their plain versions")
    return sched, chain, counts


def _layer_of(chain, scene) -> str:
    return next(n for n, sc in chain.items() if sc.with_batch(scene.B)
                == scene)


def layer_breakdown(torch, sched, chain, bucket: int = 1) -> float:
    """Time of each trunk layer's plan (padding, kernel, slicing) at
    ``bucket``, CUDA events around back-to-back calls (so the host's time
    per call counts where it is the longer), and the device time of its
    kernel alone, of every grain's kernel forced on the same layer (the
    data a calibrated selector would rank by) and of ``F.conv2d`` on the
    same input (TF32 off); returns the trunk's plan-time sum in ms."""
    from repro_torch.plan import ConvOp, make_plan

    F = torch.nn.functional
    gen = torch.Generator().manual_seed(4)
    total = k_total = lib_total = 0.0
    for name, sc in chain.items():
        plan = sched.registry.get(sc.with_batch(bucket), ConvOp.FPROP)
        x = torch.randn(plan.scene.in_shape(), generator=gen).cuda()
        w = sched._layers[name].flt
        ms = time_ms(torch, lambda: plan.execute(x, w))
        fn, inp, flt, blocks = plan.kernel_call(x, w)
        k_ms = device_ms(torch, lambda: fn(inp, flt, plan.exec_scene,
                                           **blocks))
        total += ms
        k_total += k_ms
        forced = {}
        for grain in ("TB11", "TB18", "TB88"):
            try:
                fp = make_plan(plan.scene, policy=grain)
            except ValueError:
                continue
            ffn, finp, fflt, fblocks = fp.kernel_call(x, w)
            forced[grain] = round(device_ms(torch, lambda: ffn(
                finp, fflt, fp.exec_scene, **fblocks)), 4)
        sc = plan.scene
        x_nchw = x.permute(3, 2, 0, 1).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            lib_ms = device_ms(torch, lambda: F.conv2d(
                x_nchw, w_oihw, stride=(sc.stdH, sc.stdW),
                padding=(sc.padH, sc.padW)))
        lib_total += lib_ms
        print(f"  {name} B={bucket} {plan.describe()} "
              f"{getattr(plan.choice, 'tile', '')}: {ms:.4f} ms "
              f"(kernel {k_ms:.4f}, modeled "
              f"{plan.choice.predicted_s * 1e3:.4f}, "
              f"{sc.flops / k_ms / 1e6:.1f} GFLOP/s); "
              f"F.conv2d {lib_ms:.4f} ms; forced grains ms {forced}")
    print(f"  trunk B={bucket}: plans {total:.4f} ms per forward (events), "
          f"kernels {k_total:.4f} ms (device), F.conv2d layer by layer "
          f"{lib_total:.4f} ms (device)")
    return total


def timing_phase(torch, sched, chain, counts, errs):
    """Per kernel, at its layer of ``TIMING_LAYERS`` (batch 1): kernel,
    plain version, F.conv2d; where the selector picks another grain
    there, the grain is forced (the row says so).  A second row,
    ``<name>_main_path``, times the grain's served plan whose kernel took
    the longest (device time) and names its layer and bucket."""
    from repro_torch.plan import ConvOp, make_plan

    rows = []
    gen = torch.Generator().manual_seed(10)
    for grain in ("TB11", "TB18", "TB88"):
        name = TIMING_LAYERS[grain]
        plan = sched.registry.get(chain[name].with_batch(1), ConvOp.FPROP)
        where = name
        if plan.schedule != grain:
            plan = make_plan(plan.scene, policy=grain)
            where = f"{name} (forced: off the main path)"
        rows.append(_grain_row(torch, sched, chain, plan, counts, errs,
                               f"mg3m_{grain.lower()}", where))
        served = []
        for p in sched.registry.plans().values():
            if p.schedule != grain:
                continue
            x = torch.randn(p.scene.in_shape(), generator=gen).cuda()
            w = sched._layers[_layer_of(chain, p.scene)].flt
            fn, inp, flt, blocks = p.kernel_call(x, w)
            served.append((device_ms(torch, lambda: fn(
                inp, flt, p.exec_scene, **blocks)), p))
        if not served:
            raise AssertionError(f"{grain} serves no plan on the main path")
        slow = max(served, key=lambda t: t[0])[1]
        rows.append(_grain_row(
            torch, sched, chain, slow, counts, errs,
            f"mg3m_{grain.lower()}_main_path",
            f"{_layer_of(chain, slow.scene)} (served: the longest of "
            f"{len(served)} {grain} plans)"))
    return rows


def _grain_row(torch, sched, chain, plan, counts, errs, row_name, where):
    """One ``kernels`` row: the plan's kernel, its plain version and
    ``F.conv2d`` on one seeded input, beside the kernel's bound."""
    from repro_torch.kernels.mg3m_conv import conv_plain
    from repro_torch.launch import roofline as R

    F = torch.nn.functional
    grain, sc = plan.schedule, plan.scene
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(sc.in_shape(), generator=gen).cuda()
    w = sched._layers[_layer_of(chain, sc)].flt
    fn, inp, flt, blocks = plan.kernel_call(x, w)
    got = fn(inp, flt, sc, **blocks)
    want = conv_plain(inp, flt, sc)
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=TOL["float32"],
                          atol=TOL["float32"]):
        raise AssertionError(f"{plan.describe()} disagrees with its plain "
                             f"version (max abs err {err})")
    errs[(grain, "float32")] = max(errs.get((grain, "float32"), 0.0), err)
    x_nchw = x.permute(3, 2, 0, 1).contiguous()
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib_ms = device_ms(torch, lambda: F.conv2d(
            x_nchw, w_oihw, stride=(sc.stdH, sc.stdW),
            padding=(sc.padH, sc.padW)))
    k_ms = device_ms(torch, lambda: fn(inp, flt, sc, **blocks))
    p_ms = time_ms(torch, lambda: conv_plain(inp, flt, sc))
    nbytes = (inp.numel() * inp.element_size()
              + flt.numel() * flt.element_size()
              + got.numel() * got.element_size())
    ops_ms = sc.flops / R.PEAK_FLOPS_F32 * 1e3
    bytes_ms = nbytes / R.HBM_BW * 1e3
    print(f"  {grain} at {where} B={sc.B}: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, F.conv2d {lib_ms:.4f} ms, bound "
          f"{max(ops_ms, bytes_ms):.4f} ms")
    return {
        "name": row_name, "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES[grain],
        "launches": counts[grain],
        "max_abs_err": errs[(grain, "float32")],
        "max_abs_err_bf16": errs.get((grain, "bfloat16")),
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": lib_ms,
        "shape": f"{where} B={sc.B} {plan.describe()}",
        "gflop": sc.flops / 1e9, "mbytes": nbytes / 1e6,
    }


# --------------------------------------------------------------------------
# Train path: the full-width ResNet trunk trained on the MG3M kernels
# --------------------------------------------------------------------------
TRAIN_NET = "resnet"
TRAIN_MB = 8               # microbatch: the plans' batch
TRAIN_N_MB = 2             # microbatches per step: a global batch of 16
TRAIN_STEPS = 5            # steps inside the resolution guard, after one
# Adam at 1e-3 or more throws this 10-layer plain trunk off in its first
# steps; 1e-4 descends monotonically (probed with F.conv2d on a CPU).
TRAIN_LR = 1e-4
# max |g - g_oracle| / max |g_oracle| per parameter: tests/test_autodiff.py's
# 2e-4 (the kernels and cuDNN sum in different orders)
GRAD_TOL = 2e-4
# max |z_kernel - z| / max |z| per layer of the forward, z the F.conv2d
# pre-activation on the kernels' ReLU branches: f32 sums of K <= 4608 terms
# in two orders differ by about sqrt(K) 2^-24 of the terms' scale (4e-6),
# and each layer passes the earlier ones' differences on; five times one
# layer's is allowed.  A flipped pre-activation lies within this of 0.
FWD_TOL = 2e-5
# ReLU branch flips between the two forwards, as a share of all
# pre-activations of the microbatch
FLIP_SHARE = 1e-6
TRAIN_LIBRARY = {"fprop": "F.conv2d", "dgrad": "conv2d_input",
                 "wgrad": "conv2d_weight"}


def train_path(torch, policy: str = "analytic"):
    """The trunk's 30 plans (under ``policy``) on a fresh registry, then
    one warm-up step and ``TRAIN_STEPS`` steps inside a
    ``resolution_guard``, with the launch counts set to 0 just before and
    read just after.  Every step trains on
    the stream's batch 0: i.i.d. class prototypes give nearly the same
    pooled features at 224 x 224 after ten random-init layers, so fresh
    batches show no learning within six steps, while a fixed batch's loss
    falls (probed with F.conv2d on a CPU).  Returns the run's state."""
    from repro_torch.core.autodiff import make_model_plans
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.kernels import mg3m_conv as K
    from repro_torch.models.cnn import cnn_chain_scenes, init_cnn_from_scenes
    from repro_torch.plan import PlanRegistry
    from repro_torch.train import cnn as tc
    from repro_torch.train.optimizer import AdamWConfig

    scenes = cnn_chain_scenes(TRAIN_NET, TRAIN_MB)
    reg = PlanRegistry(device="cuda")
    t0 = time.perf_counter()
    plans = make_model_plans(scenes, registry=reg, policy=policy)
    plan_s = time.perf_counter() - t0
    walk = list(plans.plans())
    distinct = {(p.scene, p.op) for _, _, p in walk}
    if len(walk) != 3 * len(scenes) or len(reg) != len(distinct):
        raise AssertionError(f"{len(walk)} plans walked, {len(reg)} in the "
                             f"registry, for {len(scenes)} layers")
    if plans.reference_ops:
        raise AssertionError(f"trunk plans run the torch reference: "
                             f"{plans.reference_ops}")
    snap = reg.snapshot()
    params = init_cnn_from_scenes(torch.Generator().manual_seed(0), scenes,
                                  device="cuda")
    cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                      total_steps=1 + TRAIN_STEPS)
    pure_step = tc.build_cnn_train_step(
        plans, cfg, n_microbatches=TRAIN_N_MB,
        buckets=tc.make_grad_buckets(params), layer_order=plans.names())
    step = tc.jit_train_step(pure_step)
    state = tc.init_train_state(params)
    data = SyntheticImages(TRAIN_MB * TRAIN_N_MB, scenes[
        f"{TRAIN_NET}/L0"].inH, 3, 10, seed=0, noise=0.3)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch_at(0).items()}

    losses, event_ms, wall_ms = [], [], []

    def run():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        _, metrics = step(state, batch)
        end.record()
        losses.append(float(metrics["loss"]))   # waits for the step
        wall_ms.append((time.perf_counter() - t) * 1e3)
        event_ms.append(start.elapsed_time(end))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    run()                                       # warm-up
    with tc.resolution_guard():
        for _ in range(TRAIN_STEPS):
            run()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = reg.stats(since=snap)

    if stats["misses"] or stats["builds"]:
        raise AssertionError(f"plans built or missed during training: "
                             f"{stats}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    # launches attributed by the plans' routing: each microbatch runs
    # every plan once but the first layer's dgrad (images need no
    # gradient); the wrappers' per-grain counts must equal the sums
    first = plans.names()[0]
    by_dir = {}
    for name, op, plan in walk:
        if (name, op) != (first, "dgrad"):
            key = (op, plan.schedule)
            by_dir[key] = by_dir.get(key, 0) + len(losses) * TRAIN_N_MB
    want = {g: sum(n for (_, gg), n in by_dir.items() if gg == g)
            for g in counts}
    if counts != want:
        raise AssertionError(f"launches {counts} differ from the plans' "
                             f"routing {want} ({by_dir})")
    # each split wgrad plan's execute launches the second pass once
    segsum = K.segment_sum.launches
    want_segsum = sum(len(losses) * TRAIN_N_MB for _, op, plan in walk
                      if plan.segments > 1)
    if segsum != want_segsum or not segsum:
        raise AssertionError(f"{segsum} mg3m_segsum launches, the split "
                             f"wgrad plans' routing gives {want_segsum}")
    for layer, triple in plans.items():
        print(f"  {layer}: " + "; ".join(
            f"{p.op.value} {p.schedule}{p.choice.tile}"
            f"{f' S={p.segments}' if p.segments > 1 else ''} modeled "
            f"{p.predicted_s * 1e3:.3f} ms" for p in
            (triple.fprop, triple.dgrad, triple.wgrad)))
    steady = sorted(event_ms[1:])
    med = steady[len(steady) // 2]
    print(f"train path ({policy}): {len(scenes)} layers x 3 directions = "
          f"{len(walk)} "
          f"kernel plans ({len(reg)} distinct) built in {plan_s:.2f} s, "
          f"zero resolutions over "
          f"{TRAIN_STEPS} guarded steps; global batch "
          f"{TRAIN_MB * TRAIN_N_MB} in {TRAIN_N_MB} microbatches; losses "
          f"{[round(x, 4) for x in losses]}")
    print(f"  step ms (CUDA events): warm-up {event_ms[0]:.2f}, steady "
          f"{[round(x, 2) for x in event_ms[1:]]} (median {med:.2f}, "
          f"{TRAIN_MB * TRAIN_N_MB / med * 1e3:.1f} images/s); host wall "
          f"per step with the loss read {[round(x, 2) for x in wall_ms]}; "
          f"peak memory {peak_gb:.2f} GB")
    print(f"  launches by grain {counts}; by (direction, grain) "
          f"{ {f'{o}/{g}': n for (o, g), n in sorted(by_dir.items())} }; "
          f"mg3m_segsum {segsum}")
    return {"plans": plans, "walk": walk, "state": state, "batch": batch,
            "step": step, "pure_step": pure_step, "scenes": scenes,
            "counts": counts, "segsum": segsum, "step_ms": med,
            "losses": losses}


def _forward_branches(torch, run, mb, flip_share: float = FLIP_SHARE):
    """The kernels' forward of one microbatch beside ``F.conv2d``'s on the
    kernels' ReLU branches: the branches (NCHW masks), and per layer
    max |dz| / max |z|, the branch flips and the largest flipped |z| /
    max |z|.  Raises if a layer's forward differs by more than
    ``FWD_TOL`` or the flips exceed ``flip_share`` of the
    pre-activations."""
    from repro_torch.models.cnn import nhwc_to_plan

    F = torch.nn.functional
    plans, scenes, params = run["plans"], run["scenes"], run["state"].params
    masks, fwd, n_pre = {}, {}, 0
    with torch.no_grad():
        zk, zo = nhwc_to_plan(mb["images"]), mb["images"].permute(0, 3, 1, 2)
        for name in plans.names():
            sc = scenes[name]
            pre = plans[name].fprop.execute(zk, params[name])
            zk = torch.relu(pre)
            pre = pre.permute(3, 2, 0, 1)
            zo = F.conv2d(zo, params[name].permute(3, 2, 0, 1),
                          stride=(sc.stdH, sc.stdW),
                          padding=(sc.padH, sc.padW))
            scale = zo.abs().max()
            masks[name] = pre > 0
            flip = masks[name] != (zo > 0)
            n = int(flip.sum())
            fwd[name] = (((zo - pre).abs().max() / scale).item(), n,
                         (zo[flip].abs().max() / scale).item() if n else 0.0)
            n_pre += zo.numel()
            zo = zo * masks[name]
    worst = max(fwd, key=lambda k: fwd[k][0])
    flips = sum(v[1] for v in fwd.values())
    if fwd[worst][0] > FWD_TOL or flips > flip_share * n_pre:
        raise AssertionError(
            f"the kernels' forward differs from F.conv2d's: {worst} "
            f"{fwd[worst][0]:.3e} of max |z| (tol {FWD_TOL}), {flips} ReLU "
            f"branch flips of {n_pre} (at most {flip_share:g} of them); "
            f"(max |dz|, flips, max flipped |z|) by layer {fwd}")
    return masks, fwd, flips, n_pre


def train_grad_oracle(torch, run):
    """Every parameter's gradient on each microbatch through the kernels
    and through autograd of the same network on ``F.conv2d`` (TF32 off),
    and the step's gradient norm against the oracle's mean over the
    microbatches.

    Two f32 forwards that sum in different orders differ in the last bits,
    and a pre-activation within that of zero takes the other ReLU branch
    in one of them: its whole term then enters one gradient sum and not
    the other, so free-running forwards disagree by far more than
    rounding.  The oracle therefore takes each ReLU's branch from the
    kernels' forward, after ``_forward_branches`` has held that forward to
    ``F.conv2d``'s and bounded the flips; the free-running comparison and
    both sides against the branch-aligned oracle in f64 are printed for
    the first microbatch."""
    from repro_torch.train import cnn as tc
    from repro_torch.train.optimizer import global_norm

    F = torch.nn.functional
    plans, scenes = run["plans"], run["scenes"]
    params = run["state"].params

    def grads(loss_of, dtype=torch.float32):
        leaves = {k: p.detach().to(dtype).requires_grad_(True)
                  for k, p in params.items()}
        g = torch.autograd.grad(loss_of(leaves), list(leaves.values()))
        return dict(zip(leaves, g))

    def oracle_loss(p, mb, masks):
        z = mb["images"].to(p["head"].dtype).permute(0, 3, 1, 2)
        for name in plans.names():
            sc = scenes[name]
            z = F.conv2d(z, p[name].permute(3, 2, 0, 1),
                         stride=(sc.stdH, sc.stdW), padding=(sc.padH, sc.padW))
            z = torch.relu(z) if masks is None else z * masks[name]
        return tc.softmax_cross_entropy(z.mean(dim=(2, 3)) @ p["head"],
                                        mb["labels"])

    def rel(a, b):
        return {k: ((a[k].double() - b[k].double()).abs().max()
                    / b[k].double().abs().max().clamp_min(1e-30)).item()
                for k in a}

    mean = {k: torch.zeros_like(p) for k, p in params.items()}
    for i in range(TRAIN_N_MB):
        mb = {k: v[i * TRAIN_MB:(i + 1) * TRAIN_MB]
              for k, v in run["batch"].items()}
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            masks, fwd, flips, n_pre = _forward_branches(torch, run, mb)
            got = grads(lambda p: tc.cnn_loss_fn(p, mb, plans,
                                                 plans.names())[0])
            want = grads(lambda p: oracle_loss(p, mb, masks))
            if i == 0:
                free = grads(lambda p: oracle_loss(p, mb, None))
                f64 = grads(lambda p: oracle_loss(p, mb, masks),
                            torch.float64)
        for k in mean:
            mean[k] += want[k] / TRAIN_N_MB
        aligned = rel(got, want)
        worst = max(aligned, key=aligned.get)
        print(f"  microbatch {i}: gradients vs the F.conv2d oracle (the "
              f"kernels' ReLU branches): max |dg| / max |g| worst {worst} "
              f"{aligned[worst]:.3e} (tol {GRAD_TOL}); "
              f"{ {k: float(f'{v:.2e}') for k, v in aligned.items()} }; "
              f"forward max |dz| / max |z| worst "
              f"{max(v[0] for v in fwd.values()):.3e} (tol {FWD_TOL}), "
              f"{flips} ReLU branch flips of {n_pre} (largest flipped |z| / "
              f"max |z| {max(v[2] for v in fwd.values()):.3e})")
        if i == 0:
            print(f"  against the same oracle in f64: kernels worst "
                  f"{max(rel(got, f64).values()):.3e}, cuDNN f32 worst "
                  f"{max(rel(want, f64).values()):.3e}; free-running f32 "
                  f"oracle: worst {max(rel(got, free).values()):.3e}; "
                  f"(max |dz|, flips, max flipped |z|) by layer {fwd}")
            del free, f64
        if aligned[worst] > GRAD_TOL:
            raise AssertionError(f"microbatch {i}: gradient of {worst} "
                                 f"differs from the F.conv2d oracle: "
                                 f"{aligned[worst]:.3e} relative (all: "
                                 f"{aligned})")
    # the accumulated step: its (pre-clip) gradient norm is the norm of
    # the microbatches' mean gradient
    _, metrics = run["pure_step"](run["state"], run["batch"])
    step_norm = float(metrics["grad_norm"])
    want_norm = float(global_norm(mean))
    err = abs(step_norm - want_norm) / want_norm
    print(f"  step gradient norm {step_norm:.6e}, the oracle's over "
          f"{TRAIN_N_MB} microbatches {want_norm:.6e}: relative "
          f"{err:.3e} (tol {GRAD_TOL})")
    if err > GRAD_TOL:
        raise AssertionError(f"the step's gradient norm {step_norm} is not "
                             f"the oracle's mean-gradient norm {want_norm}")


def train_kernel_phase(torch, run):
    """Each (layer, direction) plan's kernel held against its plain version
    once on seeded operands (the first layer's dgrad too, though the step
    skips it), then timed: the kernel's and the plan's device time, the
    bound, and the PyTorch call computing the same function.  Returns the
    ``<grain>_train_path`` rows (each launched grain at its longest plan,
    its ``ms`` the grain's own launch: a split wgrad plan's first pass
    alone, with ``ms_with_segsum`` beside it) and the ``mg3m_segsum`` row
    (its longest second pass of the step, held bitwise to
    ``segment_sum_plain``)."""
    from repro_torch.kernels import mg3m_conv as K
    from repro_torch.kernels.mg3m_conv import conv_plain
    from repro_torch.launch import roofline as R

    F = torch.nn.functional
    grad = torch.nn.grad
    gen = torch.Generator().manual_seed(12)
    errs, timed, second = {}, [], []
    sums = {"fprop": [0.0, 0.0, 0.0], "dgrad": [0.0, 0.0, 0.0],
            "wgrad": [0.0, 0.0, 0.0]}
    first = run["plans"].names()[0]
    t0 = time.perf_counter()
    for name, op, plan in run["walk"]:
        sc = plan.scene
        a_shape, b_shape, _ = plan.io_shapes()
        es = plan.exec_scene
        scale = (es.fltH * es.fltW * es.K) ** -0.5   # outputs O(1)
        a = torch.randn(a_shape, generator=gen).cuda()
        b = (torch.randn(b_shape, generator=gen) * scale).cuda()
        fn, inp, flt, blocks = plan.kernel_call(a, b)
        got = fn(inp, flt, es, **blocks)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = conv_plain(inp, flt, es, plan.seg_taps)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=TOL["float32"],
                              atol=TOL["float32"]):
            raise AssertionError(f"{name} {plan.describe()} disagrees with "
                                 f"its plain version (max abs err {err})")
        errs[plan.schedule] = max(errs.get(plan.schedule, 0.0), err)
        del got, want
        k_ms = k1_ms = device_ms(torch, lambda: fn(inp, flt, es, **blocks))
        split = ""
        if plan.segments > 1:
            spec = K.launch_spec(es, plan.schedule, in_shape=inp.shape,
                                 flt_shape=flt.shape, **blocks)
            k1_ms = device_ms(torch, lambda: K._launch(
                f"mg3m_{plan.schedule.lower()}", spec, inp, flt))
            parts = K.workspace(inp.device, (plan.segments, es.outH,
                                             es.outW, flt.shape[3],
                                             inp.shape[3]))
            s_ms = device_ms(torch, lambda: K.segment_sum(parts,
                                                          inp.dtype))
            second.append((s_ms, name, plan, parts))
            split = (f" S={plan.segments} ({plan.seg_taps} taps a segment;"
                     f" first pass {k1_ms:.4f} ms, second pass "
                     f"{s_ms:.4f} ms)")
        p_ms = device_ms(torch, lambda: plan.execute(a, b))
        stride, pad = (sc.stdH, sc.stdW), (sc.padH, sc.padW)
        nchw = lambda t: t.permute(3, 2, 0, 1).contiguous()   # noqa: E731
        if op == "fprop":
            xa, wb = nchw(a), nchw(b)
            lib = lambda: F.conv2d(xa, wb, stride=stride,      # noqa: E731
                                   padding=pad)
        elif op == "dgrad":
            ga, wb = nchw(a), nchw(b)
            in_nchw = (sc.B, sc.IC, sc.inH, sc.inW)
            lib = lambda: grad.conv2d_input(                  # noqa: E731
                in_nchw, wb, ga, stride=stride, padding=pad)
        else:
            xa, gb = nchw(a), nchw(b)
            w_oihw = (sc.OC, sc.IC, sc.fltH, sc.fltW)
            lib = lambda: grad.conv2d_weight(                 # noqa: E731
                xa, w_oihw, gb, stride=stride, padding=pad)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            lib_ms = device_ms(torch, lib)
        out_numel = 1
        for d in plan.io_shapes()[2]:
            out_numel *= d
        nbytes = 4 * (a.numel() + b.numel() + out_numel)
        ops_ms = sc.flops / R.PEAK_FLOPS_F32 * 1e3
        bytes_ms = nbytes / R.HBM_BW * 1e3
        bound = max(ops_ms, bytes_ms)
        in_step = (name, op) != (first, "dgrad")
        if in_step:
            for i, v in enumerate((k_ms, p_ms, lib_ms)):
                sums[op][i] += v
        print(f"  {name} {op} {plan.schedule}{plan.choice.tile}{split} "
              f"{'' if in_step else '(not in the step) '}kernel "
              f"{k_ms:.4f} ms, plan {p_ms:.4f} ms (device), modeled "
              f"{plan.predicted_s * 1e3:.4f}, bound {bound:.4f} "
              f"({'operations' if ops_ms >= bytes_ms else 'bytes'}), "
              f"{TRAIN_LIBRARY[op]} {lib_ms:.4f} ms, plain {plain_ms:.1f} "
              f"ms, max abs err {err:.2e}")
        timed.append({"name": name, "op": op, "plan": plan, "k_ms": k_ms,
                      "k1_ms": k1_ms, "plain_ms": plain_ms, "lib_ms": lib_ms,
                      "bound": bound, "ops_ms": ops_ms,
                      "bytes_ms": bytes_ms, "nbytes": nbytes,
                      "in_step": in_step})
        del a, b, inp, flt
    print(f"  per microbatch, device ms summed over the step's plans "
          f"(kernel / plan / library): "
          + "; ".join(f"{op} {k:.3f} / {p:.3f} / {lb:.3f}"
                      for op, (k, p, lb) in sums.items())
          + f"; all {sum(v[0] for v in sums.values()):.3f} / "
          f"{sum(v[1] for v in sums.values()):.3f} / "
          f"{sum(v[2] for v in sums.values()):.3f}; checks and timing "
          f"{time.perf_counter() - t0:.1f} s")

    rows = []
    for grain in ("TB11", "TB18", "TB88"):
        if run["counts"][grain] == 0:
            continue
        mine = [t for t in timed if t["plan"].schedule == grain
                and t["in_step"]]
        t = max(mine, key=lambda r: r["k_ms"])
        plan = t["plan"]
        rows.append({
            "name": f"mg3m_{grain.lower()}_train_path", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES[grain],
            "launches": run["counts"][grain], "max_abs_err": errs[grain],
            "ms": t["k1_ms"], "ms_with_segsum": t["k_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"],
            "bound_by": ("operations" if t["ops_ms"] >= t["bytes_ms"]
                         else "bytes"),
            "library_ms": t["lib_ms"],
            "library": TRAIN_LIBRARY[t["op"]],
            "shape": f"{t['name']} {t['op']} (the longest of {len(mine)} "
                     f"{grain} plans of the step) {plan.describe()}",
            "gflop": plan.scene.flops / 1e9, "mbytes": t["nbytes"] / 1e6})
    rows.append(segsum_row(torch, run, second))
    return rows


def segsum_row(torch, run, second):
    """The ``mg3m_segsum`` row: the second pass of each of the step's split
    wgrad plans (device ms on the plan's workspace, from
    ``train_kernel_phase``), on seeded partials of its shape summed by the
    kernel and by ``segment_sum_plain`` in f32 and bf16 (bitwise equal:
    both add s = 0, 1, ... in order), then the kernel and ``torch.sum``
    over the segments (which computes the same function in an order of its
    own) timed in turns on those partials (device time, the mean of two
    each), beside the bound (every partial read once, the output written
    once).  The row's numbers are the longest pass's; ``splits`` lists
    every (layer, S, outputs)."""
    from repro_torch.kernels import mg3m_conv as K
    from repro_torch.launch import roofline as R

    gen = torch.Generator().manual_seed(24)
    splits = []
    for s_ms, name, plan, parts in second:
        parts = torch.randn(parts.shape, generator=gen).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            got = K.segment_sum(parts, dtype)
            want = K.segment_sum_plain(parts, dtype)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"mg3m_segsum {dtype} is not bitwise its plain version "
                    f"on {tuple(parts.shape)}: max abs err "
                    f"{(got.float() - want.float()).abs().max().item():.3e}")
        n = parts[0].numel()
        nbytes = 4 * (parts.numel() + n)
        turns = {"kernel": [], "torch.sum": []}
        for _ in range(2):
            turns["kernel"].append(device_ms(
                torch, lambda: K.segment_sum(parts, torch.float32)))
            turns["torch.sum"].append(device_ms(
                torch, lambda: parts.sum(dim=0)))
        splits.append({
            "layer": name, "segments": plan.segments, "outputs": n,
            "ms": s_ms, "ms_beside_torch_sum": sum(turns["kernel"]) / 2,
            "torch_sum_ms": sum(turns["torch.sum"]) / 2,
            "bound_ms": nbytes / R.HBM_BW * 1e3,
            "lib_err": (parts.sum(dim=0) - got).abs().max().item()})
        del parts, got, want
    t = max(splits, key=lambda t: t["ms"])
    parts = torch.randn((t["segments"], t["outputs"]), generator=gen).cuda()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    K.segment_sum_plain(parts, torch.float32)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    del parts
    for x in splits:
        print(f"  mg3m_segsum: {x['layer']} wgrad S={x['segments']} over "
              f"{x['outputs']} outputs {x['ms']:.4f} ms on the plan's "
              f"workspace; on the same partials in turns "
              f"{x['ms_beside_torch_sum']:.4f} ms, torch.sum over the "
              f"segments {x['torch_sum_ms']:.4f} ms (device; max abs diff "
              f"{x['lib_err']:.2e}); bound {x['bound_ms']:.4f} ms (bytes)")
    print(f"  mg3m_segsum: bitwise its plain version in f32 and bf16 on "
          f"every split; the longest pass {t['layer']}'s plain version "
          f"{plain_ms:.3f} ms; {run['segsum']} launches in the train path")
    nbytes = 4 * (t["segments"] + 1) * t["outputs"]
    return {"name": "mg3m_segsum", "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": "src/repro/kernels/mg3m_conv.py:333",
            "note": "no TPU kernel of its own: it does what _tb88_kernel's "
                    "acc_ref carried across the reduction's sequential "
                    "grid steps, for a split wgrad reduction",
            "launches": run["segsum"], "max_abs_err": 0.0, "ms": t["ms"],
            "plain_ms": plain_ms, "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["torch_sum_ms"],
            "library": "torch.sum",
            "shape": f"{t['layer']} wgrad's partials [{t['segments']}, "
                     f"{t['outputs']}] f32 (the longest second pass of the "
                     f"step)",
            "splits": [{k: v for k, v in x.items() if k != "lib_err"}
                       for x in splits],
            "gflop": (t["segments"] - 1) * t["outputs"] / 1e9,
            "mbytes": nbytes / 1e6}


def wgrad_shard_puzzle(torch):
    """The `oc:4` shard of L0's wgrad exec scene beside the whole scene,
    each launched with its reduction unsplit and split, with the tile,
    grid and device ms of each: unsplit, the shard runs TB88's BM = 32
    tile, slower than the whole scene's (the tile, not M, sets the time
    of one block's walk of the whole reduction; PERF.md §6)."""
    from repro_torch.core.mapping import select_schedule, smem_budget
    from repro_torch.core.scene import ConvScene
    from repro_torch.kernels import mg3m_conv as K
    from repro_torch.models.cnn import cnn_chain_scenes
    from repro_torch.plan import make_plan
    from repro_torch.plan.build import grad_filter_scene, wgrad_operands
    from repro_torch.shard import shard_sub_scene

    sc = cnn_chain_scenes(TRAIN_NET)[f"{TRAIN_NET}/L0"].with_batch(TRAIN_MB)
    es = grad_filter_scene(sc)
    gen = torch.Generator().manual_seed(25)
    a, b = wgrad_operands(
        torch.randn(sc.in_shape(), generator=gen).cuda(),
        torch.randn(sc.out_shape(), generator=gen).cuda()
        * (es.fltH * es.fltW * es.K) ** -0.5)
    parts = []
    for what, scene, flt in (("whole", es, b), ("oc:4 shard",
                                                shard_sub_scene(es, "oc", 4),
                                                b[..., :es.M // 4])):
        flt = flt.contiguous()
        # the same dims as a plain ConvScene: its plans do not split
        for sv in (ConvScene(**scene.__dict__), scene):
            choice = select_schedule(sv, budget=smem_budget("cuda"))
            fn, inp, f, blocks = make_plan(sv, policy=choice) \
                .kernel_call(a, flt)
            spec = K.launch_spec(sv, choice.schedule, in_shape=inp.shape,
                                 flt_shape=f.shape, **blocks)
            gx, gy, _, threads = K.launch_grid(spec)
            gz = spec.segments if choice.schedule == "TB88" else 1
            ms = device_ms(torch, lambda: fn(inp, f, sv, **blocks),
                           iters=5)
            how = f"split S={spec.segments}" if sv.seg_taps else "unsplit"
            parts.append(f"{what} {how} {choice.schedule}{choice.tile} grid "
                         f"({gx}, {gy}, {gz}) x {threads} threads "
                         f"{ms:.4f} ms")
    print("  the oc:4 L0 wgrad shard against the whole scene, unsplit and "
          "split (device ms): " + "; ".join(parts))


def train_profile(torch, run):
    """One more train step under ``torch.profiler``: its device busy and
    idle share.  Run last, after every timed phase, since a profiler
    session leaves the rest of its process's host work slower (the LM
    path's host-bound decode step was measured slower after one)."""
    return lm_profile(torch, lambda: run["step"](run["state"], run["batch"]),
                      f"train step (global batch {TRAIN_MB * TRAIN_N_MB})")


def train_phase(torch):
    """Train the trunk, check its gradients and kernels, time them, run the
    small-model launcher, then drop what the launcher left in the
    process-wide defaults; returns the ``<grain>_train_path`` rows and the
    trunk's run (for ``train_profile``)."""
    import gc

    from repro_torch import obs
    from repro_torch.launch import train_cnn
    from repro_torch.plan.registry import set_default_registry

    t0 = time.perf_counter()
    run = train_path(torch)
    train_grad_oracle(torch, run)
    rows = train_kernel_phase(torch, run)
    wgrad_shard_puzzle(torch)
    losses = train_cnn.main(["--check-loss"])      # device: the card
    print(f"  launcher (small CNN, defaults, on the card): {len(losses)} "
          f"steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    set_default_registry(None)
    obs.set_default_metrics(None)
    obs.set_default_tracer(None)
    obs.set_default_monitor(None)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train phase: {time.perf_counter() - t0:.1f} s; step "
          f"{run['step_ms']:.2f} ms")
    return rows, run


# --------------------------------------------------------------------------
# Tune phase: repro_torch.tune on the trunk's exact scenes, a calibration
# fitted to them, then policy="tuned" served and trained beside the
# analytic runs
# --------------------------------------------------------------------------
TUNE_BUCKETS = (1, 2, 4, 8)
TUNE_TOP_K = 4
TUNE_ITERS = 5


def tune_scenes(chain, run):
    """``{label: scene}``: the trunk's fprop scenes at every bucket of
    ``TUNE_BUCKETS`` and the train step's dgrad and wgrad exec scenes (the
    first layer's dgrad, never launched, left out; a split wgrad exec
    scene is a ``WgradScene``, tuned as its plans split it)."""
    scenes = {f"{name} fprop B={b}": sc.with_batch(b)
              for name, sc in chain.items() for b in TUNE_BUCKETS}
    first = run["plans"].names()[0]
    for name, op, plan in run["walk"]:
        if op != "fprop" and (name, op) != (first, "dgrad"):
            scenes[f"{name} {op} B={TRAIN_MB}"] = plan.exec_scene
    return scenes


def tune_and_calibrate(torch, chain, run):
    """Tune every scene of ``tune_scenes`` on the card into a fresh
    ``ScheduleCache`` (at ``$REPRO_TORCH_TUNE_CACHE``, the smoke's
    temporary directory), with no measurement allowed to fail or to run
    out of time; then fit, save and reload a calibration from it.  Returns
    the cache."""
    from repro_torch import tune
    from repro_torch.core.mapping import select_schedule, smem_budget
    from repro_torch.obs.metrics import default_metrics

    m = default_metrics()
    n0 = m.value("repro.tune.measurements")
    f0 = m.value("repro.tune.measure_failures")
    o0 = m.value("repro.tune.measure_timeouts")
    cache = tune.ScheduleCache()
    tune.set_default_cache(cache)
    backend = tune.default_backend("cuda")
    budget = smem_budget("cuda")
    scenes = tune_scenes(chain, run)
    t0 = time.perf_counter()
    agree = 0
    for label, sc in scenes.items():
        a = select_schedule(sc, budget=budget)
        t = tune.autotune_scene(sc, cache=cache, top_k=TUNE_TOP_K,
                                iters=TUNE_ITERS, device="cuda")
        agree += (t.choice.schedule, t.choice.tile) == (a.schedule, a.tile)
        print(f"  {label}: analytic {a.schedule}{a.tile} modeled "
              f"{a.predicted_s * 1e3:.4f} ms, measured "
              f"{t.analytic_measured_us * 1e-3:.4f} ms; tuned "
              f"{t.choice.schedule}{t.choice.tile} "
              f"{t.measured_us * 1e-3:.4f} ms ({t.n_candidates} timed)")
    tune_s = time.perf_counter() - t0
    measured = m.value("repro.tune.measurements") - n0
    failures = m.value("repro.tune.measure_failures") - f0
    timeouts = m.value("repro.tune.measure_timeouts") - o0
    path = cache.save()
    distinct = len(set(scenes.values()))   # a dgrad scene may be an fprop's
    print(f"tune: {len(scenes)} exact scenes ({distinct} distinct), "
          f"{int(measured)} candidates "
          f"measured, {int(failures)} failures, {int(timeouts)} timeouts, "
          f"tuned pick = analytic pick "
          f"on {agree}; {tune_s:.1f} s; backend {backend!r}, "
          f"{tune.CODE_VERSION}, cache {path}")
    if failures or timeouts or len(cache) != distinct:
        raise AssertionError(f"{int(failures)} measurements failed, "
                             f"{int(timeouts)} timed out; "
                             f"{len(cache)} of {distinct} scenes cached")

    report = tune.fit_calibration(cache, backend=backend)
    calib = tune.save_calibration(report)
    if tune.load_calibration(calib, backend=backend).corrections != \
            report.cost_model().corrections:
        raise AssertionError("calibration artifact round trip differs")
    for f in report.classes:
        print(f"  class {f.cls}: {f.n_samples} samples, {f.method}, median "
              f"|pred - meas| / meas {f.median_err_before:.3f} -> "
              f"{f.median_err_after:.3f}")
    print(f"calibrate: {report.n_records} samples ({report.n_skipped} "
          f"skipped); median |pred - meas| / meas "
          f"{report.median_err_before:.3f} -> {report.median_err_after:.3f};"
          f" artifact {calib}")
    if not report.n_records:
        raise AssertionError("no calibration samples")
    return cache


def _trunk_kernel_ms(torch, sched, chain, bucket: int) -> float:
    """Device time of the trunk's kernels at ``bucket`` under ``sched``'s
    plans (one seeded input per layer)."""
    from repro_torch.plan import ConvOp

    gen = torch.Generator().manual_seed(21)
    total = 0.0
    for name, sc in chain.items():
        plan = sched.registry.get(sc.with_batch(bucket), ConvOp.FPROP,
                                  policy=sched.policy)
        x = torch.randn(plan.scene.in_shape(), generator=gen).cuda()
        fn, inp, flt, blocks = plan.kernel_call(x, sched._layers[name].flt)
        total += device_ms(torch, lambda: fn(inp, flt, plan.exec_scene,
                                             **blocks))
    return total


def tuned_serve(torch, sched, chain, cache):
    """A second scheduler over the same trunk and weights under
    ``policy="tuned"``: every plan from the tune cache, then the same
    requests at each bucket served by both sessions, bitwise equal, with
    no measurement, plan build or resolution while serving.  Returns the
    tuned plans."""
    from repro_torch.obs.metrics import default_metrics
    from repro_torch.plan import ConvOp
    from repro_torch.serve.sched import ConvScheduler, SchedConfig

    m = default_metrics()
    tsched = ConvScheduler(max_batch=8, strict=True, policy="tuned",
                           device="cuda",
                           config=SchedConfig(max_gather_s=0.005,
                                              flush_margin_s=0.002))
    tsched.register_net("resnet", chain,
                        {n: sched._layers[n].flt for n in chain},
                        activation=torch.relu)
    h0, miss0 = cache.hits, cache.misses
    tsched.prewarm(compile=True)
    n_plans = len(tsched.registry)
    if cache.hits - h0 != n_plans or cache.misses != miss0:
        raise AssertionError(f"{n_plans} tuned plans built with "
                             f"{cache.hits - h0} tune-cache hits and "
                             f"{cache.misses - miss0} misses")
    plans = list(tsched.registry.plans().values())
    asess, tsess = sched.session("resnet"), tsched.session("resnet")
    sc0 = chain["resnet/L0"]
    gen = torch.Generator().manual_seed(20)
    snap = tsched.snapshot()
    meas0 = m.value("repro.tune.measurements")
    res0 = m.value("repro.plan.resolutions")
    n_out = 0
    for b in TUNE_BUCKETS:
        xs = [torch.randn(sc0.in_shape()[:3] + (1,), generator=gen)
              for _ in range(b)]
        want, got = asess.serve(xs), tsess.serve(xs)
        for w, g in zip(want, got):
            if not torch.equal(w, g):
                raise AssertionError(
                    f"bucket {b}: the tuned session's output differs from "
                    f"the analytic session's (max abs diff "
                    f"{(w - g).abs().max().item()})")
            n_out += 1
    stats = tsched.stats(since=snap)
    resolutions = m.value("repro.plan.resolutions") - res0
    measured = m.value("repro.tune.measurements") - meas0
    if resolutions or measured or stats["plan_builds"] or \
            stats["plan_misses"]:
        raise AssertionError(f"tuned serving resolved {resolutions}, "
                             f"measured {measured}: {stats}")
    grains = {name: {b: tsched.registry.get(sc.with_batch(b), ConvOp.FPROP,
                                            policy="tuned").schedule
                     for b in TUNE_BUCKETS} for name, sc in chain.items()}
    print(f"tuned serve: {n_plans} plans, all {cache.hits - h0} from the "
          f"tune cache; {n_out} outputs at buckets {TUNE_BUCKETS} bitwise "
          f"equal to the analytic session's; 0 resolutions, 0 measurements "
          f"while serving; grains {grains}")
    for b in TUNE_BUCKETS:
        a_ms = _trunk_kernel_ms(torch, sched, chain, b)
        t_ms = _trunk_kernel_ms(torch, tsched, chain, b)
        print(f"  trunk kernels per forward, B={b}: analytic {a_ms:.4f} ms, "
              f"tuned {t_ms:.4f} ms (device)")
    return plans


def _wgrad_kernel_ms(torch, run) -> dict:
    """Device ms of each layer's wgrad kernel in ``run`` (seeded
    operands)."""
    gen = torch.Generator().manual_seed(22)
    out = {}
    for name, op, plan in run["walk"]:
        if op != "wgrad":
            continue
        a_shape, b_shape, _ = plan.io_shapes()
        a = torch.randn(a_shape, generator=gen).cuda()
        b = torch.randn(b_shape, generator=gen).cuda()
        fn, inp, flt, blocks = plan.kernel_call(a, b)
        out[name] = (device_ms(torch, lambda: fn(inp, flt, plan.exec_scene,
                                                 **blocks)),
                     f"{plan.schedule}{plan.choice.tile}")
    return out


def _step_ms(torch, run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run["step"](run["state"], run["batch"])
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def tuned_train(torch, run):
    """The trainer of ``train_path`` again, its plans under
    ``policy="tuned"``: its losses must equal the analytic run's bitwise,
    with no measurement; then step ms of both runs, interleaved, and each
    layer's wgrad kernel ms beside the analytic run's.  Returns the tuned
    trainer's plans."""
    from repro_torch.obs.metrics import default_metrics

    m = default_metrics()
    meas0 = m.value("repro.tune.measurements")
    tuned = train_path(torch, policy="tuned")
    if m.value("repro.tune.measurements") != meas0:
        raise AssertionError("the tuned trainer measured")
    if tuned["losses"] != run["losses"]:
        raise AssertionError(f"tuned losses {tuned['losses']} differ from "
                             f"the analytic run's {run['losses']}")
    times = {"analytic": [], "tuned": []}
    for _ in range(5):
        for key, r in (("analytic", run), ("tuned", tuned)):
            times[key].append(_step_ms(torch, r))
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    wa, wt = _wgrad_kernel_ms(torch, run), _wgrad_kernel_ms(torch, tuned)
    print(f"tuned train: {len(tuned['losses'])} losses bitwise equal to the "
          f"analytic run's; step ms (CUDA events, median of 5, "
          f"interleaved): analytic {med['analytic']:.2f}, tuned "
          f"{med['tuned']:.2f}; wgrad kernels per microbatch: analytic "
          f"{sum(v[0] for v in wa.values()):.3f} ms, tuned "
          f"{sum(v[0] for v in wt.values()):.3f} ms (device)")
    for name in wa:
        print(f"  {name} wgrad: analytic {wa[name][1]} {wa[name][0]:.4f} "
              f"ms, tuned {wt[name][1]} {wt[name][0]:.4f} ms")
    plans = [p for _, _, p in tuned["walk"]]
    del tuned
    return plans


def tune_phase(torch, sched, chain, run):
    """Tune, calibrate, then serve and train under ``policy="tuned"``.
    Returns the tuned plans (serving's and training's)."""
    import gc

    t0 = time.perf_counter()
    cache = tune_and_calibrate(torch, chain, run)
    plans = tuned_serve(torch, sched, chain, cache)
    plans += tuned_train(torch, run)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"tune phase: {time.perf_counter() - t0:.1f} s")
    return plans


# --------------------------------------------------------------------------
# LM path: full-width zamba2-7b through ServeEngine (causal_conv1d, flash)
# --------------------------------------------------------------------------
LM_ARCH = "zamba2-7b"
LM_KERNELS = {
    "causal_conv1d": ("src/repro_torch/csrc/causal_conv1d.cu",
                      "src/repro/kernels/causal_conv1d.py:38"),
    "flash_attention_fwd": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:75"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:75"),
    "causal_conv1d_bwd": ("src/repro_torch/csrc/causal_conv1d.cu",
                          "src/repro/kernels/causal_conv1d.py:38"),
}
# the backward's tolerances are of max |g| per gradient (causal_conv1d's
# against F.conv1d's autograd, TF32 off; its plain version is bitwise)
LM_TOL = {("causal_conv1d", "float32"): 1e-4,
          ("flash_attention_fwd", "float32"): 2e-4,
          ("flash_attention_bwd", "float32"): 2e-4,
          ("causal_conv1d_bwd", "float32"): 2e-4,
          ("causal_conv1d", "bfloat16"): 2e-2,
          ("flash_attention_fwd", "bfloat16"): 2e-2,
          ("flash_attention_bwd", "bfloat16"): 2e-2,
          ("causal_conv1d_bwd", "bfloat16"): 2e-2}
# (B, L, D, K): tests/test_kernels.py:88-90
CONV1D_SHAPES = [(2, 32, 16, 4), (1, 7, 5, 3), (3, 100, 64, 4),
                 (2, 16, 16, 2), (1, 64, 128, 4)]
# (B, S, T, Hq, Hkv, D): tests/test_flash_kernel.py:27-32, then D = 112,
# then those shapes at D = 128 (the dense configs' head dim) and a ragged one
FLASH_SHAPES = [(2, 64, 64, 4, 4, 32), (2, 64, 64, 8, 2, 32),
                (1, 128, 128, 4, 1, 64), (2, 96, 96, 2, 2, 16),
                (2, 255, 255, 8, 4, 112)]
FLASH_SHAPES += [shape[:5] + (128,) for shape in FLASH_SHAPES]
# the backward kernels' small cases: D = 112 with a ragged S, a group of 8,
# D = 16 and D = 128 with S not a multiple of 64 and T != S
FLASH_BWD_SHAPES = [(2, 255, 255, 8, 4, 112), (1, 128, 128, 8, 1, 64),
                    (2, 96, 96, 2, 2, 16), (1, 200, 130, 4, 2, 128)]
# the forward's log-sum-exp against the plain version's, absolute.  The
# bf16 kernel sums l over P rounded to bf16 (the P that multiplies V), each
# term within bf16's unit roundoff 2^-8 of its value, so ln l is within
# about 2^-8 of the exact one, plus f32 rounding: 4e-3.  The first causal
# rows, with few keys, keep that error unaveraged (1.03e-3 to 1.28e-3 read
# on an H100, against 1.9e-4 to 6.8e-4 non-causal).  f32 adds f32 terms
# (4.8e-7 read on the small shapes): 1e-5.
LSE_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
# the f32 kernel (three TF32 terms) against flash_attention_3xtf32_plain,
# which takes the same exact products and sums them in another order:
# sqrt(3D) u sqrt(D) D^-0.5 = 1.2e-6 in a score, sqrt(3T) u |o| = 6.6e-6 in
# a row of P V at T = 4096, the largest of 10^7 outputs about five such
# deviations out (csrc/flash_attention.cu's header derives it)
XTF32_TOL = 5e-5
# the f32 backward kernels (three TF32 terms) against
# flash_attention_bwd_3xtf32_plain, of max |g|: the tensor cores add each
# mma's exact products into f32 with truncation, up to 2^-23 of the running
# sum toward zero, 2^-24 on average; at most 3 * 4096 / 8 / 2 = 768 such
# adds reach a dQ element at T = 4096 (two warps split its keys), 192 a dK
# or dV element's segment: 768 * 2^-24 = 4.6e-5 of max |g| were every running
# sum as large, beside the emulation's own 1e-5 (tested on the CPU)
# (csrc/flash_attention.cu's `namespace bwd` derives it)
XTF32_BWD_TOL = 1e-4
# the bf16 backward kernels against flash_attention_bwd_bf16_plain, of max
# |g|: both round P and dS to bf16 at the same places and each output once,
# so their f32 sums differ only by the order of the adds (the tensor cores
# truncate each add, up to 2^-23 of the running sum, over at most T / 16 =
# 256 adds at T = 4096), exp2 against exp (2^-22 of P) and the rare P or dS
# whose bf16 rounding those flip (one bf16 step, 2^-7 of that term; some
# 1e-3 of them at the training shape's scores, summed with random signs,
# near 2^-7 sqrt(30 / 32768) = 2.4e-4 of |g| over a dK element's 32768
# terms): below 2^-9 of max |g| before rounding.  Two nearly equal f32
# sums round to bf16 values at most one step apart, and a step is at most
# 2^-7 of max |g|: one bf16 step plus 2^-9 (csrc/flash_attention.cu's
# bf16 backward states where it rounds)
XBF16_BWD_TOL = 2 ** -7 + 2 ** -9
# the tensor cores' dense TF32 rate (H100 SXM datasheet); the f32 kernel's
# three terms a product leave a third of it
PEAK_FLOPS_TF32 = 495e12
# the dense path's prefill (qwen2.5-3b, 2 x 2048 tokens): q (2*16, 2048,
# 128), k/v (2*2, 2048, 128), 8 query heads per kv head, causal
DENSE_FLASH = (2, 2048, 2048, 16, 2, 128)
# the D = 128 timing: q (B*H = 64, 2048, 128), 4 query heads per kv head
FLASH128_B, FLASH128_H, FLASH128_HKV = 2, 32, 8
PREFILL_B, PREFILL_S = 2, 2048
ORACLE_S = 256            # lengths over the SSD chunk (256) must be multiples
# max |decode - forward| / max |logit| in bf16: each layer rounds some ten
# intermediates at 2^-9 relative, which add over 81 layers like a random
# walk to about sqrt(810) * 2^-9 = 0.056 of the hidden state's scale; the
# head carries that to the logits.  Twice that is allowed.
ORACLE_TOL = 0.1
PROMPT_LENS = (17, 64, 255, 600)
MAX_NEW = 16
MAX_LEN = 640


def lm_shapes(cfg):
    """The kernels' operand shapes on the LM path's prefill: causal_conv1d
    x ``[B, L, conv_dim]`` and K; flash q ``(B*H, S, D)``, k/v
    ``(B*Hkv, S, D)``."""
    conv_dim = cfg.ssm.expand * cfg.d_model \
        + 2 * cfg.ssm.n_groups * cfg.ssm.state
    return ((PREFILL_B, PREFILL_S, conv_dim), cfg.ssm.conv_kernel,
            (PREFILL_B * cfg.n_heads, PREFILL_S, cfg.d_head),
            (PREFILL_B * cfg.n_kv_heads, PREFILL_S, cfg.d_head))


def _hold(torch, name, dtype, got, want, errs, what, key=None):
    """Hold ``got`` to the plain version's ``want`` at ``LM_TOL``; the
    error is kept under ``(key or name, dtype)``."""
    tol = LM_TOL[(name, dtype)]
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"{name} {dtype} disagrees with its plain "
                             f"version (max abs err {err}) on {what}")
    k = (key or name, dtype)
    errs[k] = max(errs.get(k, 0.0), err)


def _hold_grads(torch, dtype, got, want, errs, what, key):
    """Hold the backward kernels' (dq, dk, dv) to the plain version's
    within ``LM_TOL`` of max |g| per gradient; the worst ratio is kept
    under ``(key, dtype)``."""
    tol = LM_TOL[("flash_attention_bwd", dtype)]
    for name, g, w in zip("qkv", got, want):
        rel = ((g.float() - w.float()).abs().max()
               / w.float().abs().max()).item()
        if not rel <= tol:
            raise AssertionError(f"flash_attention_bwd {dtype} d{name}: "
                                 f"{rel} of max |g| from its plain version "
                                 f"(tol {tol}) on {what}")
        errs[(key, dtype)] = max(errs.get((key, dtype), 0.0), rel)


def _hold_f32_flash(torch, q, k, v, causal, got, errs, what, key):
    """The f32 kernel's ``got`` beside its other contracts: within
    ``XTF32_TOL`` of ``flash_attention_3xtf32_plain`` (kept under ``(key,
    "float32")``), bitwise from run to run, and bitwise the ``o`` of the
    launch with the log-sum-exp."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_3xtf32_plain, flash_attention_fwd)

    emu = flash_attention_3xtf32_plain(q, k, v, causal=causal)
    err = (got - emu).abs().max().item()
    if not err <= XTF32_TOL:
        raise AssertionError(f"flash_attention_fwd float32: {err} from "
                             f"flash_attention_3xtf32_plain (tol "
                             f"{XTF32_TOL}) on {what}")
    errs[(key, "float32")] = max(errs.get((key, "float32"), 0.0), err)
    del emu
    again = flash_attention_fwd(q, k, v, causal=causal)
    with_lse, _ = flash_attention_fwd(q, k, v, causal=causal,
                                      return_lse=True)
    if not (torch.equal(got, again) and torch.equal(got, with_lse)):
        raise AssertionError(f"flash_attention_fwd float32 is not bitwise "
                             f"from run to run, or with the log-sum-exp, "
                             f"on {what}")


def _hold_f32_bwd(torch, args, causal, got, errs, what, key):
    """The f32 backward kernels' (dq, dk, dv) within ``XTF32_BWD_TOL`` of
    max |g| of ``flash_attention_bwd_3xtf32_plain`` on ``args`` (q, k, v,
    out, lse, dout); the worst ratio kept under ``(key, "float32")``."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_3xtf32_plain)

    want = flash_attention_bwd_3xtf32_plain(*args, causal=causal)
    for name, g, w in zip("qkv", got, want):
        rel = ((g - w).abs().max() / w.abs().max()).item()
        if not rel <= XTF32_BWD_TOL:
            raise AssertionError(f"flash_attention_bwd float32 d{name}: "
                                 f"{rel} of max |g| from "
                                 f"flash_attention_bwd_3xtf32_plain (tol "
                                 f"{XTF32_BWD_TOL}) on {what}")
        errs[(key, "float32")] = max(errs.get((key, "float32"), 0.0), rel)


def _hold_bf16_bwd(torch, args, causal, got, errs, what, key):
    """The bf16 backward kernels' (dq, dk, dv) within ``XBF16_BWD_TOL`` of
    max |g| of ``flash_attention_bwd_bf16_plain`` on ``args`` (q, k, v,
    out, lse, dout); the worst ratio kept under ``(key, "bfloat16")``."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_bf16_plain)

    want = flash_attention_bwd_bf16_plain(*args, causal=causal)
    for name, g, w in zip("qkv", got, want):
        rel = ((g.float() - w.float()).abs().max()
               / w.float().abs().max()).item()
        if not rel <= XBF16_BWD_TOL:
            raise AssertionError(f"flash_attention_bwd bfloat16 d{name}: "
                                 f"{rel} of max |g| from "
                                 f"flash_attention_bwd_bf16_plain (tol "
                                 f"{XBF16_BWD_TOL}) on {what}")
        errs[(key, "bfloat16")] = max(errs.get((key, "bfloat16"), 0.0), rel)


def flash_bwd_batch_check(torch, dtype, shape=(3, 1152, 1152, 8, 2, 128)):
    """The backward kernels on a batch of 3 sequences (b, s, t, hq, hkv, d;
    causal, a group of 4 whose dK/dV walk is split in both dtypes) and on
    each sequence alone: every sequence's (dq, dk, dv) bitwise equal (the
    DP ring's bitwise check rests on it)."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)

    b, s, t, hq, hkv, d = shape
    gen = torch.Generator().manual_seed(30)
    tdt = getattr(torch, dtype)
    q, do = (torch.randn(b, hq, s, d, generator=gen).to("cuda", tdt)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, t, d, generator=gen).to("cuda", tdt)
            for _ in range(2))

    def grads(sl):
        qs, ks, vs, dos = (x[sl].reshape(-1, x.shape[2], d).contiguous()
                           for x in (q, k, v, do))
        out, lse = flash_attention_fwd(qs, ks, vs, causal=True,
                                       return_lse=True)
        return [g.view(-1, g.shape[0] // (sl.stop - sl.start), *g.shape[1:])
                for g in flash_attention_bwd(qs, ks, vs, out, lse, dos,
                                             causal=True)]

    batch = grads(slice(0, b))
    for i in range(b):
        alone = grads(slice(i, i + 1))
        if not all(torch.equal(a[0], g[i]) for a, g in zip(alone, batch)):
            raise AssertionError(f"flash_attention_bwd {dtype}: sequence {i} "
                                 f"alone differs bitwise from itself in a "
                                 f"batch of {b} at q ({hq}, {s}, {d})")


def flash_bwd_check(torch, q, k, v, dout, causal, dtype, errs, what, key):
    """The forward kernel with its log-sum-exp: ``o`` bitwise the ``o`` of
    the launch without it, the log-sum-exp within ``LSE_TOL`` of
    ``flash_attention_plain``'s (kept under ``("lse:" + key, dtype)``).
    Then the backward kernels on (q, k, v, dout) and that output and
    log-sum-exp, run twice: bitwise equal, and held to
    ``flash_attention_bwd_plain`` (``_hold_grads``) and, in f32, to
    ``flash_attention_bwd_3xtf32_plain`` (``_hold_f32_bwd``, kept under
    ``("xtf32:" + key, "float32")``), in bf16 to
    ``flash_attention_bwd_bf16_plain`` (``_hold_bf16_bwd``, kept under
    ``("xbf16:" + key, "bfloat16")``)."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_fwd,
                                                     flash_attention_plain)

    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    if not torch.equal(out, flash_attention_fwd(q, k, v, causal=causal)):
        raise AssertionError(f"flash_attention_fwd {dtype}: o with the "
                             f"log-sum-exp is not bitwise o without it on "
                             f"{what}")
    want = flash_attention_plain(q, k, v, causal=causal, return_lse=True)[1]
    err = (lse - want).abs().max().item()
    if not err <= LSE_TOL[dtype]:
        raise AssertionError(f"flash_attention_fwd {dtype}: log-sum-exp "
                             f"{err} from its plain version (tol "
                             f"{LSE_TOL[dtype]}) on {what}")
    errs[("lse:" + key, dtype)] = max(errs.get(("lse:" + key, dtype), 0.0),
                                      err)
    del want
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_attention_bwd {dtype} is not bitwise "
                             f"from run to run on {what}")
    _hold_grads(torch, dtype, got, flash_attention_bwd_plain(
        q, k, v, out, lse, dout, causal=causal), errs, what, key)
    if dtype == "float32":
        _hold_f32_bwd(torch, (q, k, v, out, lse, dout), causal, got, errs,
                      what, "xtf32:" + key)
    else:
        _hold_bf16_bwd(torch, (q, k, v, out, lse, dout), causal, got, errs,
                       what, "xbf16:" + key)


def conv1d_bwd_check(torch, x, w, dy, dtype, errs, what, key):
    """causal_conv1d's backward kernels on (x, w, dy), run twice: bitwise
    equal, bitwise ``causal_conv1d_bwd_plain``, and within ``LM_TOL`` of
    max |g| of ``F.conv1d``'s autograd gradients of the same function in
    f32 (TF32 off), the worst ratio kept under ``(key, dtype)``."""
    from repro_torch.kernels.causal_conv1d import (causal_conv1d_bwd,
                                                   causal_conv1d_bwd_plain)

    F = torch.nn.functional
    got = causal_conv1d_bwd(x, w, dy)
    again = causal_conv1d_bwd(x, w, dy)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"causal_conv1d_bwd {dtype} is not bitwise "
                             f"from run to run on {what}")
    want = causal_conv1d_bwd_plain(x, w, dy)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(got, want))
        raise AssertionError(f"causal_conv1d_bwd {dtype} is not bitwise its "
                             f"plain version on {what} (max abs diff "
                             f"{diff:.3e})")
    kw, length, c = w.shape[0], x.shape[1], x.shape[2]
    leaves = [x.float().transpose(1, 2).contiguous().requires_grad_(True),
              w.float().t().contiguous()[:, None, :].requires_grad_(True)]
    with torch.enable_grad(), torch.backends.cudnn.flags(enabled=True,
                                                         allow_tf32=False):
        y = F.conv1d(*leaves, padding=kw - 1, groups=c)[..., :length]
        gx, gw = torch.autograd.grad(y, leaves,
                                     dy.float().transpose(1, 2))
    tol = LM_TOL[("causal_conv1d_bwd", dtype)]
    for name, g, o in (("x", got[0], gx.transpose(1, 2)),
                       ("w", got[1], gw[:, 0].t())):
        rel = ((g.float() - o).abs().max() / o.abs().max()).item()
        if not rel <= tol:
            raise AssertionError(f"causal_conv1d_bwd {dtype} d{name}: {rel} "
                                 f"of max |g| from F.conv1d's (tol {tol}) "
                                 f"on {what}")
        errs[(key, dtype)] = max(errs.get((key, dtype), 0.0), rel)


def lm_kernel_phase(torch):
    """causal_conv1d and flash attention on the reference's test shapes and
    the LM path's, f32 and bf16, each launch held against the plain
    version on the same operands; causal_conv1d's backward kernels on the
    reference's shapes (``conv1d_bwd_check``) and flash's on
    ``FLASH_BWD_SHAPES``.  Returns max abs errors (of max |g| for the
    backward)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.causal_conv1d import (causal_conv1d,
                                                   causal_conv1d_plain)
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)

    (b0, l0, c0), k0, (bh, s0, d0), (bhkv, _, _) = lm_shapes(
        get_config(LM_ARCH))
    conv_shapes = CONV1D_SHAPES + [(b0, l0, c0, k0)]
    flash_shapes = FLASH_SHAPES + [(PREFILL_B, s0, s0, bh // PREFILL_B,
                                    bhkv // PREFILL_B, d0), DENSE_FLASH]
    gen = torch.Generator().manual_seed(5)
    errs, checks = {}, 0
    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)

        def rand(*shape):
            return torch.randn(shape, generator=gen).to("cuda", tdt)

        for b, l, d, k in conv_shapes:
            x, w = rand(b, l, d), rand(k, d)
            _hold(torch, "causal_conv1d", dtype, causal_conv1d(x, w),
                  causal_conv1d_plain(x, w), errs, f"x {(b, l, d)} K={k}")
            checks += 1
        for b, l, d, k in CONV1D_SHAPES:
            conv1d_bwd_check(torch, rand(b, l, d), rand(k, d), rand(b, l, d),
                             dtype, errs, f"x {(b, l, d)} K={k}",
                             "causal_conv1d_bwd")
            checks += 2
        for b, s, t, hq, hkv, d in flash_shapes:
            q, k, v = rand(b * hq, s, d), rand(b * hkv, t, d), \
                rand(b * hkv, t, d)
            for causal in (True, False):
                got = flash_attention_fwd(q, k, v, causal=causal)
                want = flash_attention_plain(q, k, v, causal=causal)
                what = (f"q {tuple(q.shape)} k {tuple(k.shape)} "
                        f"causal={causal}")
                _hold(torch, "flash_attention_fwd", dtype, got, want, errs,
                      what)
                if dtype == "float32" and (b, s, t, hq, hkv, d) in \
                        FLASH_SHAPES:
                    _hold_f32_flash(torch, q, k, v, causal, got, errs,
                                    what, "flash_f32")
                if d == 128:
                    _hold(torch, "flash_attention_fwd", dtype, got, want,
                          errs, what, key="flash_d128")
                if (b, s, t, hq, hkv, d) == DENSE_FLASH and causal:
                    _hold(torch, "flash_attention_fwd", dtype, got, want,
                          errs, what, key="flash_dense")
                checks += 1
        for b, s, t, hq, hkv, d in FLASH_BWD_SHAPES:
            q, k, v = rand(b * hq, s, d), rand(b * hkv, t, d), \
                rand(b * hkv, t, d)
            dout = rand(b * hq, s, d)
            for causal in (True, False):
                flash_bwd_check(torch, q, k, v, dout, causal, dtype, errs,
                                f"q {tuple(q.shape)} k {tuple(k.shape)} "
                                f"causal={causal}", "flash_attention_bwd")
                checks += 2
        flash_bwd_batch_check(torch, dtype)
        checks += 8
    torch.cuda.synchronize()
    print(f"LM kernels: {checks} launches held against their plain "
          f"versions in {time.perf_counter() - t0:.1f} s; max abs err "
          f"{ {f'{n}/{d}': e for (n, d), e in sorted(errs.items())} }")
    return errs


def _lm_counts():
    from repro_torch.kernels.causal_conv1d import (causal_conv1d,
                                                   causal_conv1d_bwd)
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    return {"causal_conv1d": causal_conv1d.launches,
            "causal_conv1d_bwd": causal_conv1d_bwd.launches,
            "flash_attention_fwd": flash_attention_fwd.launches,
            "flash_attention_bwd": flash_attention_bwd.launches}


def _reset_lm_counts():
    from repro_torch.kernels.causal_conv1d import (causal_conv1d,
                                                   causal_conv1d_bwd)
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    causal_conv1d.launches = 0
    causal_conv1d_bwd.launches = 0
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0


def _serve(torch, cfg, model, prompts, join: bool):
    """Greedy requests through a fresh 2-slot ServeEngine; with ``join``
    the first request decodes one step alone before the rest are
    submitted.  Returns (requests, latency s by rid, decode steps)."""
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(cfg, model, slots=2, max_len=MAX_LEN)
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    sent, lat = {0: time.perf_counter()}, {}
    eng.submit(reqs[0])
    if join:
        eng.step()
    for r in reqs[1:]:
        sent[r.rid] = time.perf_counter()
        eng.submit(r)
    steps = int(join)
    while eng.queue or any(a is not None for a in eng.active):
        eng.step()                 # ends in a host read of the tokens
        steps += 1
        now = time.perf_counter()
        for r in reqs:
            if r.done and r.rid not in lat:
                lat[r.rid] = now - sent[r.rid]
    return reqs, lat, steps


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "mg3m" in low:
        return "mg3m_conv"
    if "flash_fwd" in low or "flash_bwd" in low:
        return "flash_attention"
    if "causal_conv1d" in low:
        return "causal_conv1d"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "sm90")):
        return "matmul"
    if "reduce" in low or "softmax" in low or "scan" in low:
        return "reduction"
    if "elementwise" in low or "copy" in low or "cat" in low:
        return "elementwise/copy"
    return "other"


def lm_profile(torch, fn, label: str):
    """One call of ``fn`` under ``torch.profiler``: wall time, the
    device's busy time (the sum of kernel times; one stream) and idle
    share, and device time by kernel class.  Profiling adds host time, so
    the idle share is an upper bound.  Returns ``{"wall_ms", "busy_ms",
    "idle"}``, or None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print(f"  profile {label}: wall {wall_ms:.1f} ms; the profiler saw "
              f"no device time (device busy time not measured)")
        return None
    by_class = {}
    for e in kernels:
        c = _kernel_class(e.key)
        ms, n = by_class.get(c, (0.0, 0))
        by_class[c] = (ms + e.self_device_time_total / 1e3, n + e.count)
    parts = ", ".join(f"{c} {ms:.1f} ms ({ms / busy_ms:.0%}, {n} launches)"
                      for c, (ms, n) in sorted(by_class.items(),
                                               key=lambda kv: -kv[1][0]))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    print(f"  profile {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle {1 - busy_ms / wall_ms:.0%}; {parts}; "
          f"top kernels: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms "
              f"x{e.count}" for e in top))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle": 1 - busy_ms / wall_ms}


def cross_form_oracle(torch, model, inp, label: str, tol=ORACLE_TOL,
                      argmax: bool = False, **kw):
    """The reference's cross-form oracle (tests/test_models.py:47-72):
    ``prefill`` of all but the last position of ``inp`` (``{"tokens"}`` or
    ``{"embeds"}``, batch first) and one ``decode_step`` must give
    ``forward``'s logits at the last position, within ``tol`` of max
    |logit| (``tol=None``: measured, not gated) and, with ``argmax``,
    the same argmax.  ``kw`` goes to ``forward`` and ``prefill``."""
    F = torch.nn.functional
    (name, x), = inp.items()
    b, s = x.shape[:2]
    full, _ = model(**inp, **kw)
    _, cache = model.prefill(**{name: x[:, :-1]}, **kw)
    if "kv" in cache:                    # rwkv6's state has no seq axis
        cache["kv"] = {k: F.pad(v, (0, 0, 0, 0, 0, 1))
                       for k, v in cache["kv"].items()}
    dec, _ = model.decode_step(cache, torch.full((b,), s - 1, device="cuda"),
                               **{name: x[:, -1:]})
    want, got = full[:, -1], dec[:, 0]
    if not (torch.isfinite(want).all() and torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite logits in the oracle")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).tolist()
    print(f"  {label}: oracle prefill({s - 1}) + decode_step vs forward("
          f"{s}): max |diff| / max |logit| = {rel:.3e} "
          f"({'not gated' if tol is None else f'tol {tol}'}), max |logit| "
          f"{want.abs().max().item():.3f}, argmax agrees {agree}")
    if tol is not None and (rel > tol or (argmax and not all(agree))):
        raise AssertionError(f"{label}: decode does not match forward: "
                             f"{rel}, argmax agrees {agree}")
    return rel


def card_vs_cpu(torch, small, gen) -> float:
    """A reduced (f32) config seeded on the CPU and copied to the card:
    the card's ``prefill`` logits of 2 x 32 tokens must lie within 1e-3 of
    the CPU's.  Returns the max abs error."""
    import copy

    from repro_torch.models.transformer import init_params

    cpu_model = init_params(small, seed=1, device="cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    stoks = torch.randint(0, small.vocab, (2, 32), generator=gen)
    lc, _ = cpu_model.prefill(tokens=stoks)
    lg, _ = card_model.prefill(tokens=stoks.cuda())
    err = (lg.cpu() - lc).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"reduced {small.name}: card prefill logits "
                             f"differ from the CPU's by {err}")
    return err


def lm_path(torch, np):
    """Full-width zamba2-7b on the card: the cross-form oracle, then the
    main path (prefill 2 x 2048, ServeEngine) with launch counts read
    around it, the isolation check and the card-vs-CPU check on the
    reduced config.  Returns the main path's launch counts and its times
    (prefill s, decode step ms, request latency p50/max ms, the two
    profiles)."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.models.transformer import init_params

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)                 # device None: the card
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"LM path: {cfg.name} ({cfg.n_layers} layers: "
          f"{len(model.groups)} groups of {cfg.attn_every} + "
          f"{len(model.tail)} tail; d_model {cfg.d_model}, {cfg.n_heads}x"
          f"{cfg.d_head} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, SSM "
          f"state {cfg.ssm.state}, {cfg.dtype}), {n_params / 1e9:.3f} B "
          f"params, {n_bytes / 1e9:.2f} GB, seeded init "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(6)

    def tokens(b, s):
        return torch.randint(0, cfg.vocab, (b, s), generator=gen).cuda()

    with torch.no_grad():
        # the reference's cross-form oracle (tests/test_models.py:47-72)
        cross_form_oracle(torch, model, {"tokens": tokens(2, ORACLE_S)},
                          cfg.name)

        # the main path, launch counts read around it
        prompt_rng = np.random.default_rng(7)
        prompts = [prompt_rng.integers(0, cfg.vocab, n).tolist()
                   for n in PROMPT_LENS]
        ptoks = tokens(PREFILL_B, PREFILL_S)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_lm_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(tokens=ptoks)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        reqs, lat, steps = _serve(torch, cfg, model, prompts, join=True)
        counts = _lm_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if tuple(logits.shape) != (PREFILL_B, PREFILL_S, cfg.vocab) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 f"not finite or misshapen")
        kv_shape = tuple(cache["kv"]["k"].shape)
        if kv_shape != (len(model.groups), PREFILL_B, PREFILL_S,
                        cfg.n_kv_heads, cfg.d_head):
            raise AssertionError(f"prefill KV cache {kv_shape}")
        del logits, cache
        for r in reqs:
            if not (r.done and len(r.out) == MAX_NEW
                    and all(0 <= t < cfg.vocab for t in r.out)):
                raise AssertionError(f"request {r.rid} not served: {r}")
        for name in ("causal_conv1d", "flash_attention_fwd"):
            if counts[name] == 0:
                raise AssertionError(f"{name} never launched on the LM "
                                     f"path: {counts}")

        # isolation: the joining request's neighbour, served alone
        solo, _, _ = _serve(torch, cfg, model, prompts[:1], join=False)
        if solo[0].out != reqs[0].out:
            raise AssertionError(f"request 0 served alone gave "
                                 f"{solo[0].out}, beside a joining request "
                                 f"{reqs[0].out}")

        # decode step time at the engine's batch (2 slots)
        cache = model.init_cache(2, MAX_LEN)
        pos = torch.full((2,), PROMPT_LENS[-1], device="cuda")
        tok = tokens(2, 1)
        dec_ms = time_ms(torch, lambda: model.decode_step(cache, pos,
                                                          tokens=tok),
                         iters=10)
        dec_prof = lm_profile(
            torch, lambda: model.decode_step(cache, pos, tokens=tok),
            "decode step, 2 slots")
        del cache
        pre_prof = lm_profile(torch, lambda: model.prefill(tokens=ptoks),
                              f"prefill {PREFILL_B}x{PREFILL_S}")

        # the card against the CPU on the reduced config (f32)
        small = reduced(cfg)
        small_err = card_vs_cpu(torch, small, gen)

    ms = np.asarray([lat[r.rid] for r in reqs]) * 1e3
    print(f"  prefill {PREFILL_B}x{PREFILL_S} tokens: {prefill_s:.3f} s, "
          f"{PREFILL_B * PREFILL_S / prefill_s:.0f} tokens/s")
    print(f"  ServeEngine: {len(reqs)} requests (prompts {PROMPT_LENS}, "
          f"{MAX_NEW} new each) in {steps} steps; request latency p50 "
          f"{np.percentile(ms, 50):.1f} ms, max {ms.max():.1f} ms "
          f"({ {r.rid: round(lat[r.rid] * 1e3, 1) for r in reqs} }); "
          f"decode step at 2 slots {dec_ms:.2f} ms")
    print(f"  isolation: request 0 gives {reqs[0].out[:6]}... alone and "
          f"beside a joining request; reduced {small.name} card vs CPU "
          f"prefill logits max abs err {small_err:.3e}; peak memory "
          f"{peak_gb:.1f} GB")
    print(f"  launches on the LM path: {counts}")
    del model
    torch.cuda.empty_cache()
    return counts, {"prefill_s": prefill_s, "decode_ms": dec_ms,
                    "p50_ms": float(np.percentile(ms, 50)),
                    "max_ms": float(ms.max()), "decode_profile": dec_prof,
                    "prefill_profile": pre_prof}


# --------------------------------------------------------------------------
# Attention-block LM path: qwen2.5-3b through ServeEngine, grok-1-314b
# (MoE, depth cut), musicgen-large (embeddings in), reduced configs
# --------------------------------------------------------------------------
DENSE_ARCH = "qwen2.5-3b"
MOE_ARCH = "grok-1-314b"
# 2 of grok-1's 64 layers: 11.45 B parameters, 22.9 GB in bf16 (all 64
# are 633 GB, over one 80 GB card)
MOE_LAYERS = 2
MOE_PROMPT_LENS = PROMPT_LENS[:2]
AUDIO_ARCH = "musicgen-large"
REDUCED_ARCHS = ("qwen3-14b", "arctic-480b")
DECODE_ITERS = 11


def median_ms(torch, fn, iters: int = DECODE_ITERS) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` calls, each between
    two CUDA events (the host's time included), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _describe(cfg, model) -> str:
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    ffn = (f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} x "
           f"{cfg.moe.d_ff_expert}" if cfg.moe else f"d_ff {cfg.d_ff}")
    return (f"{cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads}x{cfg.d_head} heads over {cfg.n_kv_heads} kv, "
            f"{ffn}, vocab {cfg.vocab}, {cfg.norm}/{cfg.mlp}/{cfg.pos}, "
            f"{cfg.dtype}), {n_params / 1e9:.3f} B params, "
            f"{n_bytes / 1e9:.2f} GB")


def _check_served(reqs, vocab: int) -> None:
    for r in reqs:
        if not (r.done and len(r.out) == MAX_NEW
                and all(0 <= t < vocab for t in r.out)):
            raise AssertionError(f"request {r.rid} not served: {r}")


def _isolation(torch, cfg, model, prompts, reqs) -> None:
    """The joining request's neighbour, served alone, gives its tokens."""
    solo, _, _ = _serve(torch, cfg, model, prompts[:1], join=False)
    if solo[0].out != reqs[0].out:
        raise AssertionError(f"{cfg.name}: request 0 served alone gave "
                             f"{solo[0].out}, beside a joining request "
                             f"{reqs[0].out}")


class _DropLog:
    """Records ``drop_frac`` of every ``moe_ffn`` call while entered (the
    transformer calls it through the module, one call per layer)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.inner, self.fracs = moe, moe.moe_ffn, []

        def logged(*args, **kw):
            y, stats = self.inner(*args, **kw)
            self.fracs.append(stats["drop_frac"])
            return y, stats
        moe.moe_ffn = logged
        return self

    def __exit__(self, *exc):
        self.moe.moe_ffn = self.inner
        self.fracs = [float(f) for f in self.fracs]


def dense_lm(torch, np, gen) -> dict:
    """Full-width qwen2.5-3b: the oracle, then with the launch counts set
    to 0 a 2 x 2048 prefill and a 2-slot ServeEngine on 4 requests; the
    isolation check, the decode step (median, CUDA events), the f32 head's
    cost in it, and two profiles."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config(DENSE_ARCH)
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    weight_bytes = torch.cuda.memory_allocated() - base
    print(f"attention LM path: {_describe(cfg, model)}, seeded init "
          f"{time.perf_counter() - t0:.1f} s")

    def tokens(b, s):
        return torch.randint(0, cfg.vocab, (b, s), generator=gen).cuda()

    cross_form_oracle(torch, model, {"tokens": tokens(2, ORACLE_S)},
                      cfg.name)
    prompt_rng = np.random.default_rng(9)
    prompts = [prompt_rng.integers(0, cfg.vocab, n).tolist()
               for n in PROMPT_LENS]
    ptoks = tokens(PREFILL_B, PREFILL_S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_lm_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens=ptoks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    reqs, lat, steps = _serve(torch, cfg, model, prompts, join=True)
    counts = _lm_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefill_peak = torch.cuda.max_memory_allocated() - base
    if tuple(logits.shape) != (PREFILL_B, PREFILL_S, cfg.vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             f"finite or misshapen")
    kv_shape = tuple(cache["kv"]["k"].shape)
    if kv_shape != (cfg.n_layers, PREFILL_B, PREFILL_S, cfg.n_kv_heads,
                    cfg.d_head):
        raise AssertionError(f"prefill KV cache {kv_shape}")
    del logits, cache
    _check_served(reqs, cfg.vocab)
    if counts["flash_attention_fwd"] == 0:
        raise AssertionError(f"flash_attention_fwd never launched on the "
                             f"{cfg.name} path: {counts}")
    _isolation(torch, cfg, model, prompts, reqs)

    cache = model.init_cache(2, MAX_LEN)
    pos = torch.full((2,), PROMPT_LENS[-1], device="cuda")
    tok = tokens(2, 1)
    torch.cuda.synchronize()
    decode_args = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    dec_ms = median_ms(torch, lambda: model.decode_step(cache, pos,
                                                        tokens=tok))
    decode_peak = torch.cuda.max_memory_allocated() - base
    dec_prof = lm_profile(
        torch, lambda: model.decode_step(cache, pos, tokens=tok),
        f"{cfg.name} decode step, 2 slots")
    del cache
    # the f32 head (unembed) at the decode step's shape: its bf16 -> f32
    # copy of the tied embedding, and the whole head
    x = torch.randn((2, 1, cfg.d_model), generator=gen).to("cuda", model.dtype)
    copy_ms = device_ms(torch, lambda: model.embed.T.float(), iters=5)
    head_ms = device_ms(torch, lambda: model.unembed(x), iters=5)
    pre_prof = lm_profile(torch, lambda: model.prefill(tokens=ptoks),
                          f"{cfg.name} prefill {PREFILL_B}x{PREFILL_S}")
    ms = np.asarray([lat[r.rid] for r in reqs]) * 1e3
    busy = dec_prof["busy_ms"] if dec_prof else None
    print(f"  {cfg.name} prefill {PREFILL_B}x{PREFILL_S} tokens: "
          f"{prefill_s:.3f} s, {PREFILL_B * PREFILL_S / prefill_s:.0f} "
          f"tokens/s")
    print(f"  {cfg.name} ServeEngine: {len(reqs)} requests (prompts "
          f"{PROMPT_LENS}, {MAX_NEW} new each) in {steps} steps; request "
          f"latency p50 {np.percentile(ms, 50):.1f} ms, max {ms.max():.1f} "
          f"ms; decode step at 2 slots {dec_ms:.2f} ms (median of "
          f"{DECODE_ITERS})")
    print(f"  {cfg.name} f32 head at decode: the bf16 -> f32 copy of the "
          f"{cfg.vocab} x {cfg.d_model} tied embedding {copy_ms:.4f} ms, the "
          f"whole head {head_ms:.4f} ms (device time) of "
          f"{'not measured' if busy is None else f'{busy:.2f}'} ms device "
          f"busy per decode step")
    print(f"  {cfg.name} isolation: request 0 gives {reqs[0].out[:6]}... "
          f"alone and beside a joining request; peak memory {peak_gb:.1f} "
          f"GB; launches on the path: {counts}")
    del model
    torch.cuda.empty_cache()
    return {"counts": counts, "prefill_s": prefill_s, "decode_ms": dec_ms,
            "head_copy_ms": copy_ms, "head_ms": head_ms,
            "decode_profile": dec_prof, "prefill_profile": pre_prof,
            "weight_bytes": weight_bytes, "prefill_peak": prefill_peak,
            "decode_args": decode_args, "decode_peak": decode_peak}


def moe_lm(torch, np, gen) -> None:
    """grok-1-314b at full width, its depth cut to ``MOE_LAYERS``: the
    oracle drop-free, a 1 x 2048 prefill at the config's capacity factor
    (drop fraction per layer, not gated), and a 2-slot ServeEngine on 2
    requests with the isolation check (which holds only if the engine
    prefills drop-free)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models.moe import drop_free_factor
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"attention LM path: {_describe(cfg, model)} (depth cut from "
          f"{get_config(MOE_ARCH).n_layers}), seeded init "
          f"{time.perf_counter() - t0:.1f} s")

    def tokens(b, s):
        return torch.randint(0, cfg.vocab, (b, s), generator=gen).cuda()

    free = drop_free_factor(cfg.moe)
    cross_form_oracle(torch, model, {"tokens": tokens(2, ORACLE_S)},
                      f"{cfg.name} (capacity factor {free})",
                      capacity_factor=free)
    with _DropLog() as log:
        t0 = time.perf_counter()
        logits, _ = model.prefill(tokens=tokens(1, PREFILL_S))
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name}: non-finite prefill logits")
    del logits
    prompt_rng = np.random.default_rng(10)
    prompts = [prompt_rng.integers(0, cfg.vocab, n).tolist()
               for n in MOE_PROMPT_LENS]
    reqs, _, steps = _serve(torch, cfg, model, prompts, join=True)
    _check_served(reqs, cfg.vocab)
    _isolation(torch, cfg, model, prompts, reqs)
    print(f"  {cfg.name} prefill 1x{PREFILL_S} at capacity factor "
          f"{cfg.moe.capacity_factor}: {pre_s:.3f} s, drop_frac per layer "
          f"{[round(f, 4) for f in log.fracs]} (informational)")
    print(f"  {cfg.name} ServeEngine: {len(reqs)} requests (prompts "
          f"{MOE_PROMPT_LENS}, {MAX_NEW} new each, one joining) in {steps} "
          f"steps; request 0 gives {reqs[0].out[:6]}... alone and beside "
          f"the joining request")
    del model
    torch.cuda.empty_cache()


def audio_lm(torch, gen) -> int:
    """musicgen-large at full width on seeded embeddings: the cross-form
    oracle (flash's bf16 D = 64 instance on a model path).  Returns the
    flash launches it made."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config(AUDIO_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"attention LM path: {_describe(cfg, model)}, seeded init "
          f"{time.perf_counter() - t0:.1f} s")
    emb = torch.randn((2, ORACLE_S, cfg.d_model), generator=gen)
    _reset_lm_counts()
    cross_form_oracle(torch, model, {"embeds": emb.to("cuda", model.dtype)},
                      cfg.name)
    launches = _lm_counts()["flash_attention_fwd"]
    if launches == 0:
        raise AssertionError(f"{cfg.name}: flash never launched")
    print(f"  {cfg.name}: flash_attention_fwd launched {launches} times at "
          f"D = {cfg.d_head}")
    del model
    torch.cuda.empty_cache()
    return launches


def attn_lm_path(torch, np) -> dict:
    """The attention-block families on the card: qwen2.5-3b served
    (the main path, launch counts read around it), grok-1-314b cut to 2
    layers, musicgen-large, and the reduced qwen3-14b and arctic-480b on
    the card against the CPU.  Returns qwen2.5-3b's counts and times."""
    from repro_torch.configs.registry import get_config, reduced

    gen = torch.Generator().manual_seed(11)
    t0 = time.perf_counter()
    with torch.no_grad():
        dense = dense_lm(torch, np, gen)
        moe_lm(torch, np, gen)
        audio_lm(torch, gen)
        errs = {arch: card_vs_cpu(torch, reduced(get_config(arch)), gen)
                for arch in REDUCED_ARCHS}
    print(f"  reduced configs, card vs CPU prefill logits max abs err "
          f"{ {a: f'{e:.3e}' for a, e in errs.items()} } (tol 1e-3)")
    print(f"attention LM path: {time.perf_counter() - t0:.1f} s")
    return dense


def kernel_row(torch, counts, errs, name, fn, plain, lib, lib_out, flops,
               nbytes, shape, row_name=None, err_key=None, launches=None):
    """One bf16 LM kernel row: the kernel held against its plain version,
    then its device time, the plain version's (CUDA events) and the
    PyTorch call's (device time), beside the bound; launches from
    ``counts`` unless given."""
    from repro_torch.launch import roofline as R
    source, replaces = LM_KERNELS[name]
    err_key = err_key or name
    got = fn()
    _hold(torch, name, "bfloat16", got, plain(), errs, shape)
    lib_err = (lib_out(lib()).float() - got.float()).abs().max().item()
    k_ms = device_ms(torch, fn)
    p_ms = time_ms(torch, plain)
    lib_ms = device_ms(torch, lib)
    nbytes += got.numel() * got.element_size()
    ops_ms = flops / R.PEAK_FLOPS_BF16 * 1e3
    bytes_ms = nbytes / R.HBM_BW * 1e3
    print(f"  {row_name or name} at {shape}: kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, library {lib_ms:.4f} ms (max abs diff "
          f"to the kernel {lib_err:.3e}), bound {max(ops_ms, bytes_ms):.4f} ms")
    return {"name": row_name or name, "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": counts[name] if launches is None else launches,
            "max_abs_err": errs[(err_key, "float32")],
            "max_abs_err_bf16": errs[(err_key, "bfloat16")],
            "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms, "shape": shape,
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


def lm_timing_phase(torch, counts, errs, dense_counts):
    """Per kernel at the LM path's prefill shapes (bf16): kernel, plain
    version and one PyTorch call computing the same function; and flash at
    the dense path's shape (``flash_attention_fwd_dense_path``, launches
    from ``dense_counts``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.causal_conv1d import (causal_conv1d,
                                                   causal_conv1d_plain)
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    from repro_torch.kernels.meta import causal_conv1d_flops, flash_flops
    from repro_torch.launch import roofline as R

    F = torch.nn.functional
    bf = torch.bfloat16
    (b, l, c), k, qshape, kvshape = lm_shapes(get_config(LM_ARCH))
    gen = torch.Generator().manual_seed(8)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to("cuda", bf)

    def row(*args, **kwargs):
        return kernel_row(torch, counts, errs, *args, **kwargs)

    x, w = rand(b, l, c), rand(k, c, scale=0.2)
    xt, wt = x.transpose(1, 2).contiguous(), w.t().contiguous()[:, None, :]
    rows = [row("causal_conv1d", lambda: causal_conv1d(x, w),
                lambda: causal_conv1d_plain(x, w),
                lambda: F.conv1d(xt, wt, padding=k - 1, groups=c)[..., :l],
                lambda y: y.transpose(1, 2),
                causal_conv1d_flops(b, l, c, k),
                (x.numel() + w.numel()) * 2,
                f"x [{b}, {l}, {c}] bf16, K={k}")]
    del x, w, xt, wt
    q, kk, v = rand(*qshape), rand(*kvshape), rand(*kvshape)
    bh, s, d = qshape
    h = bh // PREFILL_B
    q4, k4, v4 = (t.view(PREFILL_B, -1, s, d) for t in (q, kk, v))
    k4, v4 = (t.repeat_interleave(h // t.shape[1], 1) for t in (k4, v4))
    rows.append(row(
        "flash_attention_fwd",
        lambda: flash_attention_fwd(q, kk, v, causal=True),
        lambda: flash_attention_plain(q, kk, v, causal=True),
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        lambda o: o.reshape(bh, s, d), flash_flops(bh, s, s, d, True),
        (q.numel() + kk.numel() + v.numel()) * 2,
        f"q ({bh}, {s}, {d}) bf16 causal, {h} heads x {PREFILL_B}"))
    del q, kk, v, q4, k4, v4
    rows[-1]["d128"] = flash128_row(torch, row, rand, errs)
    rows.append(flash_dense_row(torch, row, rand,
                                dense_counts["flash_attention_fwd"]))
    return rows


def flash_dense_row(torch, row, rand, launches: int):
    """Flash at the dense path's prefill shape (bf16, ``DENSE_FLASH``:
    q (32, 2048, 128), k/v (4, 2048, 128), causal): kernel, plain version
    and ``scaled_dot_product_attention`` (K/V repeated to the query heads
    outside the timed call), beside the bound; the
    ``flash_attention_fwd_dense_path`` row, its launches those of
    qwen2.5-3b's main path."""
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    from repro_torch.kernels.meta import flash_flops

    F = torch.nn.functional
    b, s, _, h, hkv, d = DENSE_FLASH
    q, kk, v = rand(b * h, s, d), rand(b * hkv, s, d), rand(b * hkv, s, d)
    q4, k4, v4 = (t.view(b, -1, s, d) for t in (q, kk, v))
    k4, v4 = (t.repeat_interleave(h // hkv, 1) for t in (k4, v4))
    return row("flash_attention_fwd",
               lambda: flash_attention_fwd(q, kk, v, causal=True),
               lambda: flash_attention_plain(q, kk, v, causal=True),
               lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=True),
               lambda o: o.reshape(b * h, s, d),
               flash_flops(b * h, s, s, d, True),
               (q.numel() + kk.numel() + v.numel()) * 2,
               f"q ({b * h}, {s}, {d}) bf16 causal, {h} heads x {b}, "
               f"{hkv} kv heads ({DENSE_ARCH} prefill)",
               row_name="flash_attention_fwd_dense_path",
               err_key="flash_dense", launches=launches)


def flash128_row(torch, row, rand, errs):
    """The flash kernels' D = 128 instance (bf16) at q (64, 2048, 128),
    causal, 4 query heads per kv head: kernel, plain version and
    ``scaled_dot_product_attention``, beside the bound; returned as the
    ``d128`` entry of the ``flash_attention_fwd`` row (off the LM path:
    zamba2-7b's head dim is 112)."""
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    from repro_torch.kernels.meta import flash_flops

    F = torch.nn.functional
    b, h, hkv, s, d = (FLASH128_B, FLASH128_H, FLASH128_HKV, PREFILL_S,
                       128)
    q, kk, v = rand(b * h, s, d), rand(b * hkv, s, d), rand(b * hkv, s, d)
    q4, k4, v4 = (t.view(b, -1, s, d) for t in (q, kk, v))
    k4, v4 = (t.repeat_interleave(h // hkv, 1) for t in (k4, v4))
    got = row("flash_attention_fwd",
              lambda: flash_attention_fwd(q, kk, v, causal=True),
              lambda: flash_attention_plain(q, kk, v, causal=True),
              lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                     is_causal=True),
              lambda o: o.reshape(b * h, s, d),
              flash_flops(b * h, s, s, d, True),
              (q.numel() + kk.numel() + v.numel()) * 2,
              f"q ({b * h}, {s}, {d}) bf16 causal, {h} heads x {b}, "
              f"{hkv} kv heads")
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "shape", "gflop", "mbytes")
    out = {k: got[k] for k in keep}
    out["max_abs_err"] = errs[("flash_d128", "float32")]
    out["max_abs_err_bf16"] = errs[("flash_d128", "bfloat16")]
    return out


# --------------------------------------------------------------------------
# ssm LM path: rwkv6-3b through ServeEngine (the reference computes rwkv6
# in plain JAX, so the port's is PyTorch ops: no kernel of its own)
# --------------------------------------------------------------------------
SSM_ARCH = "rwkv6-3b"
# chunked vs scan time-mix at full width on layer 0, f32 in and out: max
# |diff| / max |y| (tests/test_models.py:87 holds the two within 5e-4)
CHUNK_TOL = 5e-4
SSM_CHUNK_S = 256
# rwkv6's cross-form oracle sums in two orders (prefill's scan, forward's
# chunks), and the gap grows with depth in the reference as in the port:
# in bf16 on the CPU at full width, 7.6e-3 at 4 layers and 3.9e-2 at 8 in
# the reference, 9.9e-3 and 5.6e-2 in the port; at reduced width from 4 to
# 32 layers the reference's grows 82-fold to 0.30 of max |logit|
# (tests/test_torch_models_ssm.py).  So the full model is gated on an f32
# copy of its weights, within SSM_F32_TOL (an H100 read 4.463e-3 at 32
# layers); the served bf16 weights on their first SSM_GATED_DEPTH layers
# within ORACLE_TOL (8.697e-3 read); both with the argmax agreeing.
# Deeper, in bf16, the gap is measured and not gated.
SSM_F32_TOL = 1e-2
SSM_GATED_DEPTH = 4
SSM_DEPTHS = (8, 16)


def ssm_lm(torch, np) -> dict:
    """Full-width rwkv6-3b: the cross-form oracle (prefill(255), a scan,
    + decode_step vs forward(256), chunked) on an f32 copy of the weights
    and on the bf16 weights' first 4 layers, gated, and measured in bf16
    at three more depths; the chunked time-mix against
    the scan on one layer, a 2 x 2048 prefill (chunked), a 2-slot
    ServeEngine on 4 greedy requests with one joining and the isolation
    check, the decode step's median of 11 and two profiles."""
    import copy

    from repro_torch.configs.registry import get_config
    from repro_torch.models import rwkv6 as R6
    from repro_torch.models.transformer import init_params

    cfg = get_config(SSM_ARCH)
    gen = torch.Generator().manual_seed(12)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"ssm LM path: {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.d_model // R6.HEAD_SIZE} heads of "
          f"{R6.HEAD_SIZE}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.norm}, "
          f"{cfg.dtype}), {n_params / 1e9:.3f} B params, "
          f"{n_bytes / 1e9:.2f} GB, seeded init "
          f"{time.perf_counter() - t0:.1f} s")

    def tokens(b, s):
        return torch.randint(0, cfg.vocab, (b, s), generator=gen).cuda()

    with torch.no_grad():
        t0 = time.perf_counter()
        otoks = {"tokens": tokens(2, ORACLE_S)}
        f32 = copy.deepcopy(model).float()
        oracle = cross_form_oracle(torch, f32, otoks,
                                   f"{cfg.name} (f32 copy)", tol=SSM_F32_TOL,
                                   argmax=True)
        del f32
        gaps, layers = {}, model.layers
        model.layers = torch.nn.ModuleList(layers[:SSM_GATED_DEPTH])
        gaps[SSM_GATED_DEPTH] = cross_form_oracle(
            torch, model, otoks, f"{cfg.name} ({SSM_GATED_DEPTH} of its "
            f"layers, bf16)", argmax=True)
        for n in SSM_DEPTHS:
            model.layers = torch.nn.ModuleList(layers[:n])
            gaps[n] = cross_form_oracle(torch, model, otoks,
                                        f"{cfg.name} ({n} of its layers, "
                                        f"bf16)", tol=None)
        model.layers = layers
        gaps[cfg.n_layers] = cross_form_oracle(torch, model, otoks,
                                               f"{cfg.name} (bf16)",
                                               tol=None)
        oracle_s = time.perf_counter() - t0
        mix = model.layers[0].mix
        x = torch.randn((2, SSM_CHUNK_S, cfg.d_model), generator=gen).cuda()
        tail = torch.zeros_like(x[:, :1])
        s0 = torch.zeros((2, cfg.d_model // R6.HEAD_SIZE, R6.HEAD_SIZE,
                          R6.HEAD_SIZE), device="cuda")
        y1, s1 = R6.rwkv6_timemix_scan(mix, x, tail, s0)
        y2, s2 = R6.rwkv6_timemix_chunked(mix, x, tail, s0)
        rel_y = ((y2 - y1).abs().max() / y1.abs().max()).item()
        rel_s = ((s2 - s1).abs().max() / s1.abs().max()).item()
        if not (torch.isfinite(y2).all() and rel_y <= CHUNK_TOL
                and rel_s <= CHUNK_TOL):
            raise AssertionError(f"{cfg.name} layer 0: chunked time-mix "
                                 f"differs from the scan: y {rel_y}, state "
                                 f"{rel_s} (tol {CHUNK_TOL})")
        del x, y1, y2, s1, s2

        prompt_rng = np.random.default_rng(13)
        prompts = [prompt_rng.integers(0, cfg.vocab, n).tolist()
                   for n in PROMPT_LENS]
        ptoks = tokens(PREFILL_B, PREFILL_S)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = model.prefill(tokens=ptoks)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if tuple(logits.shape) != (PREFILL_B, PREFILL_S, cfg.vocab) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"{cfg.name} prefill logits "
                                 f"{tuple(logits.shape)} not finite or "
                                 f"misshapen")
        st = cache["rwkv"]
        want = {"tm_x": (cfg.n_layers, PREFILL_B, 1, cfg.d_model),
                "s": (cfg.n_layers, PREFILL_B, cfg.d_model // R6.HEAD_SIZE,
                      R6.HEAD_SIZE, R6.HEAD_SIZE)}
        if any(tuple(st[k].shape) != v for k, v in want.items()):
            raise AssertionError(f"{cfg.name} prefill state "
                                 f"{ {k: tuple(t.shape) for k, t in st.items()} }")
        del logits, cache, st
        t0 = time.perf_counter()
        reqs, lat, steps = _serve(torch, cfg, model, prompts, join=True)
        serve_s = time.perf_counter() - t0
        _check_served(reqs, cfg.vocab)
        _isolation(torch, cfg, model, prompts, reqs)

        cache = model.init_cache(2, MAX_LEN)
        pos = torch.full((2,), PROMPT_LENS[-1], device="cuda")
        tok = tokens(2, 1)
        dec_ms = median_ms(torch, lambda: model.decode_step(cache, pos,
                                                            tokens=tok))
        dec_prof = lm_profile(
            torch, lambda: model.decode_step(cache, pos, tokens=tok),
            f"{cfg.name} decode step, 2 slots")
        del cache
        pre_prof = lm_profile(torch, lambda: model.prefill(tokens=ptoks),
                              f"{cfg.name} prefill {PREFILL_B}x{PREFILL_S}")
    ms = np.asarray([lat[r.rid] for r in reqs]) * 1e3
    print(f"  {cfg.name} layer 0 chunked vs scan time-mix ({SSM_CHUNK_S} "
          f"tokens, f32): max |diff| / max |y| {rel_y:.3e}, state "
          f"{rel_s:.3e} (tol {CHUNK_TOL}); bf16 oracle gap by depth "
          f"{ {n: f'{g:.3e}' for n, g in gaps.items()} }; the oracles took "
          f"{oracle_s:.1f} s")
    print(f"  {cfg.name} prefill {PREFILL_B}x{PREFILL_S} tokens (chunked): "
          f"{prefill_s:.3f} s, {PREFILL_B * PREFILL_S / prefill_s:.0f} "
          f"tokens/s; peak memory {peak_gb:.1f} GB")
    print(f"  {cfg.name} ServeEngine: {len(reqs)} requests (prompts "
          f"{PROMPT_LENS}: multiples of 64 prefilled, the rest decoded; "
          f"{MAX_NEW} new each, one joining) in {steps} steps, "
          f"{serve_s:.1f} s; request latency p50 "
          f"{np.percentile(ms, 50):.1f} ms, max {ms.max():.1f} ms; decode "
          f"step at 2 slots {dec_ms:.2f} ms (median of {DECODE_ITERS}); "
          f"request 0 gives {reqs[0].out[:6]}... alone and beside the "
          f"joining request")
    del model
    torch.cuda.empty_cache()
    return {"prefill_s": prefill_s, "decode_ms": dec_ms, "oracle": oracle,
            "bf16_gaps": gaps, "chunk_rel": rel_y, "decode_profile": dec_prof,
            "prefill_profile": pre_prof, "peak_gb": peak_gb}


# --------------------------------------------------------------------------
# LM training: qwen2.5-3b at full width through train/step, and the
# card-vs-CPU gradient oracle on reduced configs
# --------------------------------------------------------------------------
LM_TRAIN_ARCH = DENSE_ARCH
LM_TRAIN_SEQ = 4096            # train_4k's sequence length
LM_TRAIN_BATCH = 2             # train_4k's global batch 256, cut for one card
LM_TRAIN_N_MB = 2
LM_TRAIN_STEPS = 3             # timed, after the gradient check and a warm-up
# Adam's first steps move every weight by about lr * sign(g); at 3e-4 (1.5 %
# of the weights' scale) the loss of the random 3 B model rose before it
# fell.  1e-4 is about one bf16 ulp of a weight of 0.02 (no f32 master
# copy, as in the reference), so the updates still land.
LM_TRAIN_LR = 1e-4
# At 1e-4 the loss read 12.3220 -> 12.1128 -> 12.1635 -> 11.7109 (twice,
# NVIDIA H100 80GB HBM3, 700 W): after the warm-up its least reading must
# be this far (half the 0.611 read) below the first, and the last below it.
LM_TRAIN_FALL = 0.3
# zamba2-7b trained at full width, its depth cut to one group
HYBRID_TRAIN_ARCH = LM_ARCH
# the training path's flash shape: one microbatch of qwen2.5-3b at seq 4096
TRAIN_FLASH = (1, LM_TRAIN_SEQ, LM_TRAIN_SEQ, 16, 2, 128)
# train_lm's flash shape at its defaults: batch 8, seq 256, 4 heads of 64
# over 2 kv heads (f32)
TRAIN_LM_FLASH = (8, 256, 256, 4, 2, 64)
ORACLE_ARCHS = ("qwen2.5-3b", "zamba2-7b", "rwkv6-3b")
LM_GRAD_TOL = 1e-4             # of max |g| per leaf, f32


def _flash_operands(torch, shape, dtype, gen):
    b, s, t, h, hkv, d = shape
    return [torch.randn((b, n, hh, d), generator=gen).to("cuda", dtype)
            for n, hh in ((s, h), (t, hkv), (t, hkv), (s, h))]


def flash_train_checks(torch, errs):
    """At the training path's flash shape (q (16, 4096, 128), k/v (2, 4096,
    128), causal), f32 and bf16: the forward kernel against its plain
    version; the backward kernels against ``flash_attention_bwd_plain``
    (2e-4 / 2e-2 of max |g|) and bitwise from run to run; and
    ``FlashAttention``'s backward (the kernels) against autograd of the
    plain version, within the forward's tolerance of max |g|
    (``LM_TOL``).  Then the backward kernels as ``flash_bwd_check`` holds
    them at the other training paths' shapes: zamba2-7b's shared attention
    (q (32, 4096, 112), g = 1, bf16) and ``train_lm``'s (``TRAIN_LM_FLASH``,
    f32), both causal; errors kept under ``("flash_bwd:<path>", dtype)``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import (FlashAttention,
                                                     flash_attention_bshd,
                                                     flash_attention_plain)

    gen = torch.Generator().manual_seed(14)
    b, s, t, h, hkv, d = TRAIN_FLASH
    for dtype in ("float32", "bfloat16"):
        q, k, v, dout = _flash_operands(torch, TRAIN_FLASH,
                                        getattr(torch, dtype), gen)
        qf, kf, vf = (x.transpose(1, 2).reshape(-1, x.shape[1], d)
                      .contiguous() for x in (q, k, v))
        got = flash_attention_bshd(q, k, v, causal=True)
        want = flash_attention_plain(qf, kf, vf, causal=True)
        _hold(torch, "flash_attention_fwd", dtype,
              got.transpose(1, 2).reshape(-1, s, d), want, errs,
              f"q {tuple(qf.shape)} k {tuple(kf.shape)} (training shape)",
              key="flash_train")
        dof = dout.transpose(1, 2).reshape(-1, s, d).contiguous()
        flash_bwd_check(torch, qf, kf, vf, dof, True, dtype, errs,
                        f"q {tuple(qf.shape)} k {tuple(kf.shape)} (training "
                        f"shape)", "flash_train_bwd_kernels")
        del got, want, qf, kf, vf, dof
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = FlashAttention.apply(*leaves, True, 512, 1024)
        grads = torch.autograd.grad(out, leaves, dout)
        plain = [x.detach().requires_grad_(True) for x in (q, k, v)]
        pout = flash_attention_plain(
            *(x.transpose(1, 2).reshape(-1, x.shape[1], d) for x in plain),
            causal=True).reshape(b, h, s, d).transpose(1, 2)
        want = torch.autograd.grad(pout, plain, dout)
        tol = LM_TOL[("flash_attention_fwd", dtype)]
        for name, g, w in zip("qkv", grads, want):
            rel = ((g.float() - w.float()).abs().max()
                   / w.float().abs().max()).item()
            if not rel <= tol:
                raise AssertionError(f"FlashAttention backward d{name} "
                                     f"{dtype}: {rel} of max |g| (tol {tol})")
            key = ("flash_train_bwd", dtype)
            errs[key] = max(errs.get(key, 0.0), rel)
        del out, grads, pout, want, leaves, plain
    z = get_config(HYBRID_TRAIN_ARCH)
    for label, shape, dtype in (
            (z.name, (1, LM_TRAIN_SEQ, LM_TRAIN_SEQ, z.n_heads, z.n_kv_heads,
                      z.d_head), "bfloat16"),
            ("train_lm", TRAIN_LM_FLASH, "float32")):
        b, s, t, h, hkv, d = shape
        tdt = getattr(torch, dtype)
        q, k, v, dout = (torch.randn(dims, generator=gen).to("cuda", tdt)
                         for dims in ((b * h, s, d), (b * hkv, t, d),
                                      (b * hkv, t, d), (b * h, s, d)))
        flash_bwd_check(torch, q, k, v, dout, True, dtype, errs,
                        f"q {tuple(q.shape)} k {tuple(k.shape)} ({label}'s "
                        f"training shape)", f"flash_bwd:{label}")
        del q, k, v, dout
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


def lm_train_run(torch) -> dict:
    """Phase 13's qwen2.5-3b train run built from its seed: the model, its
    state (``state_bytes`` on the card), the step with its hooks, and the
    batch."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.train import optimizer as O
    from repro_torch.train import step as S

    cfg = get_config(LM_TRAIN_ARCH)
    base = torch.cuda.memory_allocated()
    model = init_params(cfg, seed=0, trainable=True)
    moments = "bfloat16" if cfg.param_count() >= 30e9 else "float32"
    state = S.init_train_state(model, moments)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated() - base
    opt_cfg = O.AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=1, total_steps=100,
                            moments_dtype=moments)
    step, hooks = S.build_train_step(
        cfg, make_host_mesh(), opt_cfg,
        S.StepPlan(n_microbatches=LM_TRAIN_N_MB), model)
    batch = S.to_device(SyntheticLM(cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                    seed=0).batch_at(0), "cuda")
    return {"model": model, "state": state, "moments": moments,
            "state_bytes": state_bytes, "opt_cfg": opt_cfg, "step": step,
            "hooks": hooks, "batch": batch}


def lm_train_phase(torch, np) -> dict:
    """qwen2.5-3b at full width trained through ``train.step``: seq 4096,
    global batch 2 in 2 microbatches of 1, AdamW (f32 moments), per-layer
    checkpointing.  With the launch counts set to 0: one step that only
    returns gradients (every parameter's must be finite and nonzero: a
    kernel output cut from the graph would leave some zero), one warm-up
    step and ``LM_TRAIN_STEPS`` timed steps on one fixed batch, whose loss
    must be finite, end below where it started and fall at least
    ``LM_TRAIN_FALL`` after the warm-up.  Flash must launch twice per
    layer per microbatch (the forward and the checkpoint's recomputation)
    and its backward run once, launching the backward kernels once.
    Returns the run (``lm_train_run``'s) and its numbers."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import ctx
    from repro_torch.train import step as S

    cfg = get_config(LM_TRAIN_ARCH)
    t_phase = time.perf_counter()
    errs = {}
    flash_train_checks(torch, errs)
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    run = lm_train_run(torch)
    model, state, moments = run["model"], run["state"], run["moments"]
    state_bytes = run["state_bytes"]
    step, hooks, batch = run["step"], run["hooks"], run["batch"]
    print(f"LM train: {_describe(cfg, model)}; checkpointing "
          f"{cfg.remat_policy}; {moments} moments; seq {LM_TRAIN_SEQ}, "
          f"global batch {LM_TRAIN_BATCH} (train_4k's "
          f"{SHAPES['train_4k']['global_batch']}, cut for one card) in "
          f"{LM_TRAIN_N_MB} "
          f"microbatches; init {time.perf_counter() - t0:.1f} s")
    grads_step, _ = S.build_train_step(
        cfg, make_host_mesh(), run["opt_cfg"],
        S.StepPlan(n_microbatches=LM_TRAIN_N_MB, skip_update=True), model)
    # each layer's forward, and again its checkpoint's recomputation
    per_step = cfg.n_layers * LM_TRAIN_N_MB * \
        (1 if cfg.remat_policy == "none" else 2)
    with ctx.activation_sharding(hooks):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_lm_counts()
        bwd0 = FlashAttention.backward_calls
        _, gm = grads_step(state, batch)
        bad = [k for k, g in gm["grads"].items()
               if not (torch.isfinite(g).all() and g.abs().max() > 0)]
        if bad:
            raise AssertionError(f"{cfg.name}: zero or non-finite gradients "
                                 f"for {len(bad)} parameters: {bad[:8]}")
        gnorm = torch.sqrt(sum(g.float().square().sum()
                               for g in gm["grads"].values())).item()
        n_grads = len(gm["grads"])
        del gm
        losses, step_ms = [], []
        for i in range(1 + LM_TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, m = step(state, batch)
            end.record()
            end.synchronize()
            losses.append(float(m["loss"]))
            if i:
                step_ms.append(start.elapsed_time(end))
        counts = _lm_counts()
        bwd = FlashAttention.backward_calls - bwd0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        step_peak = torch.cuda.max_memory_allocated() - base
    n_steps = 2 + LM_TRAIN_STEPS
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]
            and min(losses[1:]) <= losses[0] - LM_TRAIN_FALL):
        raise AssertionError(f"{cfg.name}: loss did not fall by "
                             f"{LM_TRAIN_FALL} over the warm-up and timed "
                             f"steps: {losses}")
    bwd_step = cfg.n_layers * LM_TRAIN_N_MB
    if counts["flash_attention_fwd"] != per_step * n_steps or \
            bwd != bwd_step * n_steps or \
            counts["flash_attention_bwd"] != bwd:
        raise AssertionError(f"{cfg.name}: flash launched "
                             f"{counts['flash_attention_fwd']} times, its "
                             f"backward ran {bwd} times and launched its "
                             f"kernels {counts['flash_attention_bwd']} times "
                             f"in {n_steps} steps; expected {per_step}, "
                             f"{bwd_step} and {bwd_step} per step")
    ms = float(np.median(step_ms))
    tok_s = LM_TRAIN_BATCH * LM_TRAIN_SEQ / (ms / 1e3)
    print(f"  {cfg.name} train: {n_grads} gradients finite and nonzero "
          f"(global norm {gnorm:.4f}); loss {' -> '.join(f'{x:.4f}' for x in losses)}; "
          f"step {ms:.1f} ms (median of {LM_TRAIN_STEPS}: "
          f"{[round(x, 1) for x in step_ms]}), {tok_s:.0f} tokens/s; peak "
          f"memory {peak_gb:.1f} GB; flash launched "
          f"{counts['flash_attention_fwd']} times, its backward "
          f"{bwd} times (the backward kernels "
          f"{counts['flash_attention_bwd']} times) in {n_steps} steps "
          f"({per_step} and {bwd_step} per step); the backward kernels vs "
          f"flash_attention_bwd_plain "
          f"{errs[('flash_train_bwd_kernels', 'float32')]:.2e} (f32), "
          f"{errs[('flash_train_bwd_kernels', 'bfloat16')]:.2e} (bf16), "
          f"FlashAttention backward vs the plain version's "
          f"autograd {errs[('flash_train_bwd', 'float32')]:.2e} (f32), "
          f"{errs[('flash_train_bwd', 'bfloat16')]:.2e} (bf16) of max |g|")
    print(f"LM train phase: {time.perf_counter() - t_phase:.1f} s")
    return {"model": model, "state": state, "step": step, "batch": batch,
            "hooks": hooks, "counts": counts, "errs": errs, "step_ms": ms,
            "tokens_s": tok_s, "peak_gb": peak_gb, "losses": losses,
            "state_bytes": state_bytes, "step_peak": step_peak}


def hybrid_train_step(torch) -> dict:
    """zamba2-7b at full width, its depth cut to one group (6 Mamba2 layers
    and the shared attention block), trained through ``train.step`` as
    qwen2.5-3b is: seq 4096, global batch 2 in 2 microbatches of 1, f32
    moments, the group checkpointed.  With the launch counts set to 0: a
    gradient-only step (every gradient finite and nonzero) and one update
    step, whose loss must be finite; causal_conv1d must launch twice per
    Mamba2 layer per microbatch (forward and recomputation) and its
    backward run once, launching its backward kernels once; flash's
    backward kernels must launch once per ``FlashAttention`` backward.  Returns the counts, the update step's ms
    and the peak memory; the model is dropped."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.causal_conv1d import CausalConv1d
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import ctx
    from repro_torch.train import optimizer as O
    from repro_torch.train import step as S

    full = get_config(HYBRID_TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=full.attn_every)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, trainable=True)
    state = S.init_train_state(model, "float32")
    mesh = make_host_mesh()
    opt_cfg = O.AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=1, total_steps=100)
    grads_step, hooks = S.build_train_step(
        cfg, mesh, opt_cfg, S.StepPlan(n_microbatches=LM_TRAIN_N_MB,
                                       skip_update=True), model)
    step, _ = S.build_train_step(
        cfg, mesh, opt_cfg, S.StepPlan(n_microbatches=LM_TRAIN_N_MB), model)
    batch = S.to_device(SyntheticLM(cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                    seed=0).batch_at(0), "cuda")
    print(f"LM train: {_describe(cfg, model)}, one group of the "
          f"{full.n_layers} layers; seq {LM_TRAIN_SEQ}, global batch "
          f"{LM_TRAIN_BATCH} in {LM_TRAIN_N_MB} microbatches; init "
          f"{time.perf_counter() - t0:.1f} s")
    with ctx.activation_sharding(hooks):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_lm_counts()
        c0 = CausalConv1d.backward_calls
        f0 = FlashAttention.backward_calls
        _, gm = grads_step(state, batch)
        bad = [k for k, g in gm["grads"].items()
               if not (torch.isfinite(g).all() and g.abs().max() > 0)]
        n_grads = len(gm["grads"])
        del gm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, m = step(state, batch)
        end.record()
        end.synchronize()
        counts = _lm_counts()
        conv_bwd = CausalConv1d.backward_calls - c0
        flash_bwd = FlashAttention.backward_calls - f0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss, ms = float(m["loss"]), start.elapsed_time(end)
    del model, state, step, grads_step, batch, m
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"{cfg.name} (one group): zero or non-finite "
                             f"gradients for {len(bad)} parameters: "
                             f"{bad[:8]}")
    if not math.isfinite(loss):
        raise AssertionError(f"{cfg.name} (one group): loss {loss}")
    per_step = cfg.n_layers * LM_TRAIN_N_MB
    if counts["causal_conv1d"] != 2 * 2 * per_step or \
            conv_bwd != 2 * per_step or \
            counts["causal_conv1d_bwd"] != conv_bwd:
        raise AssertionError(f"{cfg.name} (one group): causal_conv1d "
                             f"launched {counts['causal_conv1d']} times, its "
                             f"backward ran {conv_bwd} times and launched "
                             f"its kernels {counts['causal_conv1d_bwd']} "
                             f"times in 2 steps; expected {2 * per_step}, "
                             f"{per_step} and {per_step} per step")
    if not flash_bwd or counts["flash_attention_bwd"] != flash_bwd:
        raise AssertionError(f"{cfg.name} (one group): FlashAttention's "
                             f"backward ran {flash_bwd} times and launched "
                             f"the backward kernels "
                             f"{counts['flash_attention_bwd']} times")
    print(f"  {cfg.name} train (one group): {n_grads} gradients finite and "
          f"nonzero; loss {loss:.4f}; update step {ms:.1f} ms (CUDA events, "
          f"one step), {LM_TRAIN_BATCH * LM_TRAIN_SEQ / (ms / 1e3):.0f} "
          f"tokens/s; peak memory {peak_gb:.1f} GB; causal_conv1d launched "
          f"{counts['causal_conv1d']} times, its backward {conv_bwd} times "
          f"(its kernels {counts['causal_conv1d_bwd']} times), flash "
          f"{counts['flash_attention_fwd']} times and its backward "
          f"kernels {counts['flash_attention_bwd']} times in 2 steps")
    return {"counts": counts, "conv_bwd": conv_bwd, "step_ms": ms,
            "peak_gb": peak_gb}


def lm_train_profile(torch):
    """One qwen2.5-3b train step of phase 13's run under
    ``torch.profiler`` (last, as ``train_profile``).  Phase 13's own state
    is dropped before phase 19, with whose rings it does not fit on the
    card, so the run is rebuilt from its seed and takes one warm-up step
    first; then it is dropped."""
    from repro_torch.parallel import ctx

    run = lm_train_run(torch)
    with ctx.activation_sharding(run["hooks"]):
        run["step"](run["state"], run["batch"])
        torch.cuda.synchronize()
        prof = lm_profile(
            torch, lambda: run["step"](run["state"], run["batch"]),
            f"{LM_TRAIN_ARCH} train step (global batch {LM_TRAIN_BATCH} x "
            f"{LM_TRAIN_SEQ})")
    run.clear()
    torch.cuda.empty_cache()
    return prof


def _train_once(torch, cfg, model, batch, skip_update: bool):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import optimizer as O
    from repro_torch.train import step as S

    step, _ = S.build_train_step(
        cfg, make_host_mesh(model.device), O.AdamWConfig(lr=1e-3,
                                                         warmup_steps=1),
        S.StepPlan(n_microbatches=2, skip_update=skip_update), model)
    state, m = step(S.init_train_state(model), batch)
    return m["grads"] if skip_update else \
        {k: p.detach() for k, p in state.params.items()}


def lm_grad_oracle(torch) -> None:
    """Reduced qwen2.5-3b, zamba2-7b (the hybrid: causal_conv1d and flash)
    and rwkv6-3b in f32, one ``build_train_step`` step (2 microbatches of
    1 x 64 tokens) on the card and on the CPU (plain versions) from the
    same weights (a CPU model copied to the card): gradients within 1e-4
    of max |g| per leaf; parameters after the update within 1e-4 where the
    gradient exceeds 1e-4 of the leaf's max |g| (its sign fixed), and
    within 2 lr elsewhere (Adam's first step moves each element by about
    lr * sign(g)).  The card's ``FlashAttention`` and ``CausalConv1d``
    backward must each have run, each launching its backward kernels once
    per call."""
    import copy

    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.kernels.causal_conv1d import CausalConv1d
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.models.transformer import init_params

    t0 = time.perf_counter()
    out = {"flash_bwd": 0, "conv_bwd": 0, "causal_conv1d": 0,
           "causal_conv1d_bwd": 0, "flash_attention_fwd": 0,
           "flash_attention_bwd": 0}
    worst = {}
    for arch in ORACLE_ARCHS:
        cfg = reduced(get_config(arch))
        gen = torch.Generator().manual_seed(15)
        toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        cpu_model = init_params(cfg, seed=2, device="cpu", trainable=True)
        results = {}
        for dev in ("cpu", "cuda"):
            res = []
            for skip in (True, False):
                model = copy.deepcopy(cpu_model).to(dev)
                b = {k: v.to(dev) for k, v in batch.items()}
                if dev == "cuda":
                    _reset_lm_counts()
                    f0 = FlashAttention.backward_calls
                    c0 = CausalConv1d.backward_calls
                res.append(_train_once(torch, cfg, model, b, skip))
                if dev == "cuda":
                    torch.cuda.synchronize()
                    out["flash_bwd"] += FlashAttention.backward_calls - f0
                    out["conv_bwd"] += CausalConv1d.backward_calls - c0
                    for k, n in _lm_counts().items():
                        out[k] += n
            results[dev] = res
        (g_cpu, p_cpu), (g_card, p_card) = results["cpu"], results["cuda"]
        g_err = p_err = 0.0
        for k, g in g_cpu.items():
            gc = g_card[k].cpu()
            scale = g.abs().max().item()
            if not (torch.isfinite(gc).all() and scale > 0):
                raise AssertionError(f"{arch}: gradient of {k} on the card "
                                     f"is not finite or all zero")
            err = (gc - g).abs().max().item() / scale
            firm = g.abs() > LM_GRAD_TOL * scale
            d = (p_card[k].cpu() - p_cpu[k]).abs()
            e_firm = d[firm].max().item() if firm.any() else 0.0
            if err > LM_GRAD_TOL or e_firm > LM_GRAD_TOL or \
                    d.max().item() > 2e-3 + LM_GRAD_TOL:
                raise AssertionError(
                    f"reduced {arch}, {k}: card vs CPU gradient {err:.3e} of "
                    f"max |g|, updated parameters {e_firm:.3e} where the "
                    f"gradient is firm, {d.max().item():.3e} anywhere")
            g_err, p_err = max(g_err, err), max(p_err, e_firm)
        worst[arch] = (g_err, p_err)
    if not (out["flash_bwd"] and out["conv_bwd"]) or \
            out["flash_attention_bwd"] != out["flash_bwd"] or \
            out["causal_conv1d_bwd"] != out["conv_bwd"]:
        raise AssertionError(f"a kernel's backward never ran on the card, "
                             f"or did not launch its kernels once per "
                             f"call: {out}")
    print(f"LM gradient oracle (card vs CPU, f32, reduced configs): worst "
          f"gradient / updated-parameter error "
          f"{ {a: f'{g:.2e} / {p:.2e}' for a, (g, p) in worst.items()} } "
          f"(tol {LM_GRAD_TOL}); on the card FlashAttention backward ran "
          f"{out['flash_bwd']} times (its kernels "
          f"{out['flash_attention_bwd']} times), CausalConv1d backward "
          f"{out['conv_bwd']} times (its kernels "
          f"{out['causal_conv1d_bwd']} times); forward launches "
          f"{ {k: out[k] for k in ('causal_conv1d', 'flash_attention_fwd')} }; "
          f"{time.perf_counter() - t0:.1f} s")


def lm_train_rows(torch, train, hybrid, errs, bwd_split):
    """The training path's kernel rows: flash at the training shape (q
    (16, 4096, 128) bf16, causal), its launches those of the qwen2.5-3b
    train phase, beside SDPA (a yardstick); the backward kernels' row at
    the same shape (``flash_bwd_row``, with phase 8's per-kernel
    ``bwd_split``); and causal_conv1d at the hybrid's
    training shape (zamba2-7b, x [1, 4096, 7296] bf16), its launches those
    of ``hybrid_train_step``'s two steps, and its backward kernels' row
    (``conv1d_bwd_row``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.causal_conv1d import (causal_conv1d,
                                                   causal_conv1d_plain)
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    from repro_torch.kernels.meta import causal_conv1d_flops, flash_flops
    from repro_torch.launch import roofline as R

    F = torch.nn.functional
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(16)
    rows = []
    b, s, t, h, hkv, d = TRAIN_FLASH
    q4, k4, v4, do4 = _flash_operands(torch, TRAIN_FLASH, bf, gen)
    q, kk, v = (x.transpose(1, 2).reshape(-1, x.shape[1], d).contiguous()
                for x in (q4, k4, v4))
    got = flash_attention_fwd(q, kk, v, causal=True)
    k_ms = device_ms(torch, lambda: flash_attention_fwd(q, kk, v,
                                                        causal=True))
    p_ms = time_ms(torch, lambda: flash_attention_plain(q, kk, v,
                                                        causal=True),
                   iters=3)
    qs, ks, vs = (x.view(b, -1, x.shape[1], d) for x in (q, kk, v))
    ks, vs = (x.repeat_interleave(h // hkv, 1) for x in (ks, vs))
    lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True))
    bwd = flash_bwd_row(torch, train, errs, (q4, k4, v4, do4),
                        (q, kk, v), (qs, ks, vs), bwd_split)
    flops = flash_flops(b * h, s, s, d, True)
    nbytes = (q.numel() + kk.numel() + v.numel() + got.numel()) * 2
    ops_ms, bytes_ms = flops / R.PEAK_FLOPS_BF16 * 1e3, \
        nbytes / R.HBM_BW * 1e3
    source, replaces = LM_KERNELS["flash_attention_fwd"]
    rows.append({
        "name": "flash_attention_fwd_train_path", "route": "cuda",
        "source": source, "replaces": replaces,
        "launches": train["counts"]["flash_attention_fwd"],
        "max_abs_err": errs[("flash_train", "float32")],
        "max_abs_err_bf16": errs[("flash_train", "bfloat16")],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": lib_ms,
        "shape": f"q ({b * h}, {s}, {d}) bf16 causal, {h} heads over {hkv} "
                 f"kv ({LM_TRAIN_ARCH} train microbatch)",
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6})
    rows.append(bwd)
    print(f"  flash_attention_fwd_train_path at q ({b * h}, {s}, {d}) bf16: "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, SDPA {lib_ms:.4f} ms, "
          f"bound {max(ops_ms, bytes_ms):.4f} ms")
    del q4, k4, v4, do4, q, kk, v, got, qs, ks, vs

    zcfg = get_config(LM_ARCH)
    (_, _, c), kw, _, _ = lm_shapes(zcfg)
    x = torch.randn((1, LM_TRAIN_SEQ, c), generator=gen).to("cuda", bf)
    w = (torch.randn((kw, c), generator=gen) * 0.2).to("cuda", bf)
    dy = torch.randn((1, LM_TRAIN_SEQ, c), generator=gen).to("cuda", bf)
    got = causal_conv1d(x, w)
    _hold(torch, "causal_conv1d", "bfloat16", got, causal_conv1d_plain(x, w),
          errs, f"x {tuple(x.shape)} (hybrid training shape)")
    xt, wt = x.transpose(1, 2).contiguous(), w.t().contiguous()[:, None, :]
    k_ms = device_ms(torch, lambda: causal_conv1d(x, w))
    p_ms = time_ms(torch, lambda: causal_conv1d_plain(x, w))
    lib_ms = device_ms(torch, lambda: F.conv1d(xt, wt, padding=kw - 1,
                                               groups=c))
    flops = causal_conv1d_flops(1, LM_TRAIN_SEQ, c, kw)
    nbytes = (x.numel() + w.numel() + got.numel()) * 2
    ops_ms, bytes_ms = flops / R.PEAK_FLOPS_BF16 * 1e3, \
        nbytes / R.HBM_BW * 1e3
    source, replaces = LM_KERNELS["causal_conv1d"]
    rows.append({
        "name": "causal_conv1d_train_path", "route": "cuda",
        "source": source, "replaces": replaces,
        "launches": hybrid["counts"]["causal_conv1d"],
        "max_abs_err": errs[("causal_conv1d", "float32")],
        "max_abs_err_bf16": errs[("causal_conv1d", "bfloat16")],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": lib_ms,
        "shape": f"x [1, {LM_TRAIN_SEQ}, {c}] bf16, K={kw} ({LM_ARCH} train "
                 f"microbatch; launches from its one-group train steps)",
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6})
    print(f"  causal_conv1d_train_path at x [1, {LM_TRAIN_SEQ}, {c}] bf16: "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, F.conv1d "
          f"{lib_ms:.4f} ms, bound {max(ops_ms, bytes_ms):.4f} ms")
    del x, w, dy, got, xt, wt
    rows.append(conv1d_bwd_row(torch, hybrid, errs))
    return rows


# a Mamba2 TP shard's conv channels at zamba2-7b's prefill (row 4c's shape)
CONV1D_TP_SHARD = (2, 2048, 1920)


def conv1d_bwd_row(torch, hybrid, errs):
    """The ``causal_conv1d_bwd_train_path`` row: the backward kernels held
    by ``conv1d_bwd_check`` (bitwise their plain version and from run to
    run; ``F.conv1d``'s gradients within ``LM_TOL`` of max |g|) in f32 and
    bf16 at zamba2-7b's training shape (x [1, 4096, 7296]) and at a TP
    shard's ``CONV1D_TP_SHARD``; then in bf16 at the training shape their
    device time (CUDA-graph replay, both passes), the plain version's (CUDA
    events), ``F.conv1d``'s backward in device time (its forward and
    ``torch.autograd.grad`` captured in one graph, less its forward alone)
    and the bound (``meta``'s closed form: 2 x the forward's FLOPs at 989
    TFLOP/s; x, w, dy read and dx, dw written once at 3.35 TB/s; the f32
    partials apart); the TP shard's device time beside; launches those of
    ``hybrid_train_step``'s two steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.causal_conv1d import (bwd_segments,
                                                   causal_conv1d_bwd,
                                                   causal_conv1d_bwd_plain)
    from repro_torch.kernels.meta import causal_conv1d_flops
    from repro_torch.launch import roofline as R

    F = torch.nn.functional
    (_, _, c), kw, _, _ = lm_shapes(get_config(LM_ARCH))
    train = (1, LM_TRAIN_SEQ, c)
    gen = torch.Generator().manual_seed(27)
    ops = {}
    for shape in (train, CONV1D_TP_SHARD):
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            x = torch.randn(shape, generator=gen).to("cuda", tdt)
            w = (torch.randn((kw, shape[2]), generator=gen) * 0.2).to("cuda",
                                                                      tdt)
            dy = torch.randn(shape, generator=gen).to("cuda", tdt)
            conv1d_bwd_check(torch, x, w, dy, dtype, errs, f"x {shape}",
                             "causal_conv1d_bwd")
            ops[(shape, dtype)] = (x, w, dy)
    x, w, dy = ops[(train, "bfloat16")]
    k_ms = device_ms(torch, lambda: causal_conv1d_bwd(x, w, dy))
    p_ms = time_ms(torch, lambda: causal_conv1d_bwd_plain(x, w, dy), iters=3)
    tp_ms = device_ms(torch, lambda: causal_conv1d_bwd(
        *ops[(CONV1D_TP_SHARD, "bfloat16")]))
    xt, wt = x.transpose(1, 2).contiguous(), w.t().contiguous()[:, None, :]
    leaves = [t.detach().requires_grad_(True) for t in (xt, wt)]
    dyt = dy.transpose(1, 2).contiguous()

    def library():
        with torch.enable_grad():
            y = F.conv1d(*leaves, padding=kw - 1, groups=c)[..., :train[1]]
            return torch.autograd.grad(y, leaves, dyt)

    lib_ms = device_ms(torch, library) - device_ms(
        torch, lambda: F.conv1d(xt, wt, padding=kw - 1, groups=c))
    flops = 2 * causal_conv1d_flops(*train, kw)
    nbytes = (3 * x.numel() + 2 * w.numel()) * 2
    ops_ms, bytes_ms = flops / R.PEAK_FLOPS_BF16 * 1e3, \
        nbytes / R.HBM_BW * 1e3
    segs = bwd_segments(*train[:2])
    source, replaces = LM_KERNELS["causal_conv1d_bwd"]
    print(f"  causal_conv1d_bwd_train_path at x {list(train)} bf16: kernels "
          f"{k_ms:.4f} ms (both passes, S={segs}), plain {p_ms:.3f} ms, "
          f"F.conv1d's backward {lib_ms:.4f} ms (device time), bound "
          f"{max(ops_ms, bytes_ms):.4f} ms "
          f"({'operations' if ops_ms >= bytes_ms else 'bytes'}); at x "
          f"{list(CONV1D_TP_SHARD)} {tp_ms:.4f} ms; "
          f"{hybrid['counts']['causal_conv1d_bwd']} launches in "
          f"{hybrid['conv_bwd']} backward passes")
    del ops, x, w, dy, xt, wt, leaves, dyt
    return {
        "name": "causal_conv1d_bwd_train_path", "route": "cuda",
        "source": source, "replaces": replaces,
        "note": "no TPU kernel of its own: the gradient of causal_conv1d's "
                "function, which the reference's training takes by XLA "
                "autodiff of causal_conv1d_ref (src/repro/models/"
                "mamba2.py:149)",
        "launches": hybrid["counts"]["causal_conv1d_bwd"],
        "max_abs_err": errs[("causal_conv1d_bwd", "float32")],
        "max_abs_err_bf16": errs[("causal_conv1d_bwd", "bfloat16")],
        "err_of": "max |g| of F.conv1d's gradients (bitwise the plain "
                  "version)",
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": lib_ms,
        "library": "F.conv1d's backward (depthwise): its forward and "
                   "backward less its forward",
        "tp_shard_ms": tp_ms, "segments": segs,
        "shape": f"x {list(train)} bf16, K={kw} ({LM_ARCH} train "
                 f"microbatch; launches from its one-group train steps)",
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        "partials_mbytes": 2 * 4 * segs * kw * c / 1e6}


def flash_bwd_row(torch, train, errs, bshd, kernel, sdpa, bwd_split):
    """The ``flash_attention_bwd_train_path`` row at the training shape
    (q (16, 4096, 128), k/v (2, 4096, 128) bf16, causal): the backward
    kernels' device time (CUDA-graph replay), ``flash_attention_bwd_plain``'s
    and ``flash_attention_vjp``'s (the reference's chunked attention
    recomputed, the training path's backward before the kernels; CUDA
    events), SDPA's backward (device time by graph replay: SDPA's forward
    and ``torch.autograd.grad`` captured together, less its forward alone,
    whichever backend SDPA picks, named in ``library``; its gradients,
    summed over each group, held to the plain version's at
    ``_hold_grads``'s tolerance), the bound (``meta.flash_bwd_flops`` at 989 TFLOP/s bf16
    against q, k, v, o, dO, lse read and dq, dk, dv written at 3.35 TB/s),
    phase 13's launches, the backward kernels' HGMMA/HMMA counts (bf16
    and f32; every bf16 dQ and dK/dV kernel must issue HGMMA, every f32 one
    HMMA), each bf16 kernel's device ms from phase 8 (``bwd_split``: dQ,
    dK/dV and the second pass), and the errors ``flash_train_checks`` kept
    (the log-sum-exp's, against ``flash_attention_bwd_bf16_plain``, and
    the gradients' at the other training paths' shapes).  ``bshd`` is (q,
    k, v, dout) in the model's layout, ``kernel`` (q, k, v) in the
    kernels', ``sdpa`` (q, k, v) with K and V repeated to the query
    heads."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_fwd,
                                                     flash_attention_vjp)
    from repro_torch.kernels.meta import flash_bwd_flops
    from repro_torch.launch import roofline as R

    F = torch.nn.functional
    b, s, t, h, hkv, d = TRAIN_FLASH
    q, kk, v = kernel
    do = bshd[3].transpose(1, 2).reshape(-1, s, d).contiguous()
    out, lse = flash_attention_fwd(q, kk, v, causal=True, return_lse=True)

    def run():
        return flash_attention_bwd(q, kk, v, out, lse, do, causal=True)

    k_ms = device_ms(torch, run)
    p_ms = time_ms(torch, lambda: flash_attention_bwd_plain(
        q, kk, v, out, lse, do, causal=True), iters=3)
    re_ms = time_ms(torch, lambda: flash_attention_vjp(*bshd), iters=3)
    dref = do.view(b, h, s, d)
    leaves = [x.detach().requires_grad_(True) for x in sdpa]

    def library():
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(*leaves, is_causal=True)
            return torch.autograd.grad(o, leaves, dref)

    lib_ms = device_ms(torch, library) - device_ms(
        torch, lambda: F.scaled_dot_product_attention(*sdpa, is_causal=True))
    backend = _sdpa_backend(torch, *sdpa)
    grads = run()
    lib = library()
    _hold_grads(torch, "bfloat16", (
        lib[0].reshape(b * h, s, d),
        *(g.view(b, hkv, h // hkv, t, d).float().sum(2).reshape(-1, t, d)
          for g in lib[1:])),
        flash_attention_bwd_plain(q, kk, v, out, lse, do, causal=True),
        {}, "SDPA's backward at the training shape", "sdpa_bwd")
    del leaves, lib
    flops = flash_bwd_flops(b * h, s, t, d, True)
    nbytes = sum(x.numel() * x.element_size()
                 for x in (q, kk, v, out, lse, do, *grads))
    ops_ms, bytes_ms = flops / R.PEAK_FLOPS_BF16 * 1e3, \
        nbytes / R.HBM_BW * 1e3
    tc = {n: c for n, c in tensor_core_counts(
        cuda_build.build("flash_attention.cu")[0]).items() if "flash_bwd" in n}
    check_f32_bwd_hmma(tc)
    check_bf16_bwd_hgmma(tc)
    split = bwd_split.get("training_bf16", {})
    source, replaces = LM_KERNELS["flash_attention_bwd"]
    print(f"  flash_attention_bwd_train_path at q ({b * h}, {s}, {d}) bf16: "
          f"kernels {k_ms:.4f} ms, plain {p_ms:.3f} ms, SDPA's backward "
          f"{lib_ms:.4f} ms ({backend}), the recomputing backward "
          f"(flash_attention_vjp) {re_ms:.3f} ms, bound "
          f"{max(ops_ms, bytes_ms):.4f} ms "
          f"({'operations' if ops_ms >= bytes_ms else 'bytes'}); "
          f"{train['counts']['flash_attention_bwd']} launches in phase 13; "
          f"by kernel (phase 8's profiler): " + (", ".join(
              f"{n} {split[n]:.4f} ms" for n in ("dq", "dkdv", "sum")
              if n in split) or "not measured"))
    return {
        "name": "flash_attention_bwd_train_path", "route": "cuda",
        "source": source, "replaces": replaces,
        "note": "no TPU kernel of its own: the gradient of "
                "flash_attention_fwd's function, which the reference's "
                "training takes by XLA autodiff of "
                "src/repro/models/layers.py:176",
        "launches": train["counts"]["flash_attention_bwd"],
        "max_abs_err": errs[("flash_train_bwd_kernels", "float32")],
        "max_abs_err_bf16": errs[("flash_train_bwd_kernels", "bfloat16")],
        "xbf16_err": errs[("xbf16:flash_train_bwd_kernels", "bfloat16")],
        "err_of": "max |g|",
        "kernel_ms": split,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": lib_ms,
        "library": f"scaled_dot_product_attention's backward ({backend}; "
                   f"K, V repeated to the query heads): its forward and "
                   f"backward less its forward",
        "recompute_ms": re_ms,
        "max_lse_err": {f"{n[4:]}/{dt}": e
                        for (n, dt), e in sorted(errs.items())
                        if n.startswith("lse:")},
        "max_abs_err_paths": {f"{n.split(':', 1)[1]}/{dt}": e
                              for (n, dt), e in sorted(errs.items())
                              if n.startswith("flash_bwd:")},
        "xbf16_err_paths": {n.split(':', 1)[1]: e
                            for (n, dt), e in sorted(errs.items())
                            if n.startswith("xbf16:flash_bwd:")},
        "tensor_core_counts": {n: {"HGMMA": c[0], "HMMA": c[1]}
                               for n, c in tc.items()},
        "shape": f"q ({b * h}, {s}, {d}), k/v ({b * hkv}, {t}, {d}) bf16 "
                 f"causal ({LM_TRAIN_ARCH} train microbatch)",
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


# --------------------------------------------------------------------------
# static analysis, examples, dry run and roofline (phases 15, 16, 19)
# --------------------------------------------------------------------------
GRID_JOBS = 8              # most worker processes of the dry-run grid
# the steps phases 10 and 13 time, as (name, shape, batch, seq, microbatches)
CUT_CELLS = (("train_step", "train_4k", LM_TRAIN_BATCH, LM_TRAIN_SEQ,
              LM_TRAIN_N_MB),
             ("prefill", "prefill_32k", PREFILL_B, PREFILL_S, None),
             ("decode_step", "decode_32k", 2, MAX_LEN, None))


def analyze_phase(torch, plans) -> None:
    """``launch.analyze`` on the card over the six paper CNNs' full scenes
    (every feasible point, the card's own in_coord against the expected
    table for every swept exec scene, lint); then ``verify_plan`` on every
    plan of phases 4-7 and the card's in_coord on each of their exec
    scenes; 0 error findings.  For each compiled tile instance the plans
    launch: its registers, and the card's blocks per SM beside
    ``blocks_per_sm``'s at each of its plans' footprints."""
    from repro_torch.analysis import verify as V
    from repro_torch.analysis.footprint import tile_threads, vmem_bytes
    from repro_torch.analysis.lint import lint_paths
    from repro_torch.core.mapping import blocks_per_sm, device_limits
    from repro_torch.core.scene import dtype_name
    from repro_torch.kernels import mg3m_conv as K
    from repro_torch.launch import analyze

    t0 = time.perf_counter()
    if analyze.main(["--device", "cuda", "--no-cache", "--full"]) != 0:
        raise AssertionError("launch.analyze reported error findings")
    findings, scenes, instances = [], {}, {}
    for plan in plans:
        findings += V.verify_plan(plan, device="cuda")
        if plan.uses_reference:
            continue
        ex, spec, tile = plan.exec_scene, plan.spec, plan.choice.tile
        scenes[ex.describe()] = ex
        smem = vmem_bytes(ex, spec.schedule, spec.bm, spec.bn, spec.bk, tile)
        instances.setdefault((spec.schedule, tuple(tile),
                              dtype_name(ex.dtype)), set()).add(smem)
    for ex in scenes.values():
        findings += V.device_index_map(ex, "cuda")
    errors = V.errors(findings)
    if errors:
        raise AssertionError(f"{len(errors)} error findings on the plans of "
                             f"phases 4-7: {[f.message for f in errors[:4]]}")
    warned = [f for f in findings if f.code == "occupancy-overestimate"]
    print(f"analyze: {len(plans)} plans of phases 4-7 ({len(scenes)} exec "
          f"scenes) verified for the card: 0 errors, {len(warned)} "
          f"occupancy-overestimate warnings; the card's in_coord equals the "
          f"expected table on all {len(scenes)} exec scenes")
    smem_sm = device_limits("cuda")[1]
    for (grain, tile, dt), smems in sorted(instances.items()):
        pairs = []
        for smem in sorted(smems):
            a = K.tile_attributes(grain, tile, dt, smem)
            pairs.append(f"{a['blocks_per_sm']}/"
                         f"{blocks_per_sm(smem, tile_threads(tile), smem_sm)}")
        print(f"  tile {grain} {tile} {dt}: {a['registers']} registers, "
              f"{a['local_bytes']} B local a thread; blocks per SM card/"
              f"model at its {len(smems)} footprints: {', '.join(pairs)}")
    bad = lint_paths(str(SRC / "repro_torch"))
    if bad:
        raise AssertionError(f"lint: {[str(f) for f in bad[:4]]}")
    print(f"analyze phase: {time.perf_counter() - t0:.1f} s")


def measured_steps(dense, train) -> dict:
    """What phases 10 and 13 measured of the three steps of
    ``CUT_CELLS``: ms, argument bytes, peak and their descriptions."""
    return {
        "train_step": (train["step_ms"], train["state_bytes"],
                       train["step_peak"], "the state", "the train phase"),
        "prefill": (dense["prefill_s"] * 1e3, dense["weight_bytes"],
                    dense["prefill_peak"], "the weights",
                    "the prefill and serving"),
        "decode_step": (dense["decode_ms"], dense["decode_args"],
                        dense["decode_peak"], "the weights and cache",
                        "the timed decode steps")}


def mesh_model(runs: dict) -> None:
    """The dry run's model (``launch.dryrun``: one representative position
    of a (2, 2) ring of ``meta`` devices traced, its counts times the
    chips) of phase 19's two train rings: the collective bytes of a step
    against the ``repro.mesh.*`` counters measured there (they must be
    equal), and the predicted per-chip peak times the ring size beside the
    peak the card allocated (four shards on one card)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_for

    meta = make_mesh_for(2, 2, devices=("meta",) * MESH_RING)
    cells = (("dp", get_config(DENSE_ARCH), 1),
             ("tp", dataclasses.replace(get_config(TP_ARCH),
                                        n_layers=TP_LAYERS), 2))
    for key, cfg, n_mb in cells:
        r = dryrun.run_config(cfg, "train_4k", mesh=meta,
                              batch_override=MESH_BATCH,
                              seq_override=MESH_SEQ, n_microbatches=n_mb)
        model = {k.replace("-", "_"): v
                 for k, v in r["collectives"]["ring_bytes"].items()}
        run = runs[key]
        peak = r["memory"]["peak_bytes"]
        print(f"mesh model: {cfg.name} {'TP + SP' if r['tp'] else 'DP'} "
              f"grain on (2, 2): collective bytes per step, model {model}, "
              f"measured {run['coll']}; per-chip peak predicted "
              f"{peak / 1e9:.2f} GB x {MESH_RING} = "
              f"{MESH_RING * peak / 1e9:.2f} GB, measured on the card "
              f"{run['peak'] / 1e9:.2f} GB (the four shards' state on one "
              f"card, one position's transients at a time); per-chip "
              f"FLOPs {r['cost']['flops']:.4g}; traced in {r['trace_s']} s")
        if model != run["coll"]:
            raise AssertionError(f"{cfg.name}: the dry run's collective "
                                 f"model {model} != the ring's counters "
                                 f"{run['coll']}")


def roofline_phase(measured: dict, mesh_runs: Optional[dict] = None
                   ) -> None:
    """The dry run and roofline of the three steps phases 10 and 13 timed
    (qwen2.5-3b's train step, 2 x 2048 prefill and decode step at 2
    slots), traced here on the meta device after every timed phase:
    predicted argument bytes and peak beside what the card allocated, the
    traced bound and the model's own bound beside the measured time; the
    measured fraction (traced bound / time, a check of the count), the
    model fraction (model bound / time) and ``roofline_fraction`` must lie
    in (0, 1.05].  Then one JSON line per cell of the full-size grid, in
    one worker process per CPU core (at most ``GRID_JOBS``), ``fits``
    against this card's memory; the grid's cells and the three steps'
    rooflines rendered as ``launch.make_experiments``' tables."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import make_experiments as E
    from repro_torch.launch import roofline as R

    t0, roofs = time.perf_counter(), []
    for name, shape, b, seq, n_mb in CUT_CELLS:
        ms, args, peak, what, when = measured[name]
        r = R.run_cell(DENSE_ARCH, shape, batch_override=b, seq_override=seq,
                       n_microbatches=n_mb)
        roofs.append(r)
        fracs = {"measured fraction": R.measured_fraction(r, ms / 1e3),
                 "model fraction": R.model_fraction(r, ms / 1e3),
                 "roofline_fraction": r["roofline_fraction"]}
        t, mt = r["terms_s"], r["model_terms_s"]
        print(f"roofline: {DENSE_ARCH} {name} ({r['batch']} x "
              f"{r['seq_len']}, {r['n_microbatches']} microbatches): "
              f"arguments predicted {r['memory']['argument_bytes'] / 1e9:.3f}"
              f" GB, {what} allocated {args / 1e9:.3f} GB; peak predicted "
              f"{r['memory']['peak_bytes'] / 1e9:.3f} GB, over {when} "
              f"{peak / 1e9:.3f} GB; traced bound {r['bound_s'] * 1e3:.2f} "
              f"ms ({r['dominant']}; compute {t['compute'] * 1e3:.2f} ms, "
              f"memory {t['memory'] * 1e3:.2f} ms), model bound "
              f"{r['model_bound_s'] * 1e3:.2f} ms (compute "
              f"{mt['compute'] * 1e3:.2f} ms, memory "
              f"{mt['memory'] * 1e3:.2f} ms) against {ms:.2f} ms measured: "
              + ", ".join(f"{k} {v:.4f}" for k, v in fracs.items())
              + f"; FLOPs by dtype "
              f"{ {k: f'{v:.4g}' for k, v in r['flops_by_dtype'].items()} }"
              f", bytes {r['per_chip']['bytes']:.4g}, model FLOPs "
              f"{r['model_flops_global']:.4g}; traced in {r['probe_s']} s")
        for what_, f in fracs.items():
            if not 0 < f <= 1.05:
                raise AssertionError(f"{name}: {what_} {f} outside "
                                     f"(0, 1.05]: the count is wrong")
    if mesh_runs is not None:
        mesh_model(mesh_runs)
    t1, grid = time.perf_counter(), []
    jobs = min(len(os.sched_getaffinity(0)), GRID_JOBS)
    for cell in dryrun.run_grid(jobs=jobs):
        grid.append(cell)
        print(json.dumps(cell))
    n_fit = sum(bool(cell.get("fits")) for cell in grid)
    cap = dryrun.card_memory_bytes()
    print(f"dry-run grid: {n_fit} cells fit this card's {cap / 1e9:.1f} GB "
          f"({time.perf_counter() - t1:.1f} s in {jobs} processes)")
    print(E.render(grid, [], roofs))
    print(f"roofline phase {time.perf_counter() - t0:.1f} s")


def examples_phase(torch, tmp: str, bwd_split: dict) -> list:
    """The two LM examples in-process on the card: ``serve_lm`` at its
    defaults, then ``train_lm --steps 20`` (checkpoints every 10) and the
    same run resumed from its step-10 checkpoint alone, whose 10 losses
    must equal the uninterrupted run's last 10 bit for bit.  Their
    models are reduced f32 configs, so flash runs its f32 kernel
    (``flash_fwd_kernel``), which each example must launch: with the
    launch counts set to 0 after ``serve_lm`` and read after the two
    ``train_lm`` runs, returns the f32 rows (``flash_f32_rows``, with
    phase 8's ``bwd_split``)."""
    from repro_torch.examples import serve_lm, train_lm
    from repro_torch.kernels.flash_attention import FlashAttention

    t0 = time.perf_counter()
    _reset_lm_counts()
    reqs = serve_lm.main([])
    if not all(r.done and 0 < len(r.out) and all(0 <= t < 512 for t in r.out)
               for r in reqs):
        raise AssertionError(f"serve_lm: {[(r.done, r.out) for r in reqs]}")
    serve_launches = _lm_counts()["flash_attention_fwd"]
    _reset_lm_counts()
    f0 = FlashAttention.backward_calls
    full_dir, cut_dir = (tempfile.mkdtemp(dir=tmp) for _ in range(2))
    argv = ["--steps", "20", "--ckpt-every", "10"]
    full = train_lm.main(argv + ["--ckpt-dir", full_dir])
    shutil.copytree(os.path.join(full_dir, "step_00000010"),
                    os.path.join(cut_dir, "step_00000010"))
    resumed = train_lm.main(argv + ["--ckpt-dir", cut_dir, "--resume"])
    counts = _lm_counts()
    launches = counts["flash_attention_fwd"]
    bwd_launches = counts["flash_attention_bwd"]
    if not all(math.isfinite(x) for x in full) or resumed != full[10:]:
        raise AssertionError(f"train_lm: resumed losses {resumed} differ "
                             f"from the uninterrupted run's {full[10:]}")
    if serve_launches == 0 or launches == 0:
        raise AssertionError(f"flash launched {serve_launches} times in "
                             f"serve_lm, {launches} in train_lm")
    _held_flash_bwd("train_lm", counts, FlashAttention.backward_calls - f0)
    print(f"examples: serve_lm served {len(reqs)} requests (flash launched "
          f"{serve_launches} times); train_lm "
          f"{len(full)} steps, loss {full[0]:.4f} -> {full[-1]:.4f}, "
          f"resumed at step 10 bitwise equal (flash launched {launches} "
          f"times over both runs, at the f32 row's shape, its f32 backward "
          f"kernels {bwd_launches} times); "
          f"{time.perf_counter() - t0:.1f} s")
    rows = flash_f32_rows(torch, launches, bwd_launches, bwd_split)
    conv_examples(torch, tmp)
    return rows


def _example(torch, name: str, fn):
    """``fn()`` with the MG3M launch counts set to 0 before and read
    after: (its result, launches per grain, wall seconds).  At least one
    MG3M kernel must have launched."""
    from repro_torch.kernels import mg3m_conv as K

    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    if not sum(counts.values()):
        raise AssertionError(f"{name} launched no MG3M kernel: {counts}")
    return out, counts, wall


def conv_examples(torch, tmp: str) -> None:
    """The four conv examples in-process on the card at their defaults
    (phase 16's second half; see the module docstring)."""
    from repro_torch.examples import mg3m_cnn, quickstart, serve_cnn, \
        serve_conv
    from repro_torch.kernels import mg3m_conv as K
    from repro_torch.launch import obsreport
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.plan.build import ConvPlan

    t0 = time.perf_counter()
    got, counts, wall = _example(torch, "quickstart",
                                 lambda: quickstart.main([]))
    print(f"examples: quickstart launches {counts}, {wall:.2f} s; max |err| "
          f"{got['err']:.3e} against the oracle, one-shot call "
          f"{got['one_shot_err']:.3e} from the plan")

    plans = os.path.join(tmp, "serve_conv_plans.json")
    got, counts, wall = _example(torch, "serve_conv",
                                 lambda: serve_conv.main(["--plans", plans]))
    first, second = got["first"], got["second"]
    if not all(torch.equal(a, b) for a, b in zip(first["outs"],
                                                  second["outs"])):
        raise AssertionError("serve_conv: the reloaded plans' outputs "
                             "differ from the first process's")
    print(f"examples: serve_conv launches {counts}, {wall:.2f} s; cold "
          f"{first['cold_ms']:.1f} ms then {first['warm_ms']:.3f} "
          f"ms/request; reloaded {got['loaded']} plans, cold "
          f"{second['cold_ms']:.1f} ms then {second['warm_ms']:.3f} "
          f"ms/request, misses {second['stats']['misses']}, outputs "
          f"bitwise equal")

    # launches per direction: each ConvPlan.execute's share of the counts
    by_dir = {"fprop": 0, "dgrad": 0, "wgrad": 0}
    execute = ConvPlan.execute

    def counted(plan, a, b):
        before = sum(K.launch_counts().values())
        out = execute(plan, a, b)
        by_dir[plan.op.value] += sum(K.launch_counts().values()) - before
        return out

    ConvPlan.execute = counted
    try:
        got, counts, wall = _example(torch, "mg3m_cnn",
                                     lambda: mg3m_cnn.main([]))
    finally:
        ConvPlan.execute = execute
    if not all(by_dir.values()) or sum(by_dir.values()) != sum(
            counts.values()):
        raise AssertionError(f"mg3m_cnn launches by direction {by_dir}, by "
                             f"grain {counts}")
    picks = "; ".join(
        f"{n} " + "/".join(p.schedule or "plain"
                           for p in (t.fprop, t.dgrad, t.wgrad))
        for n, t in got["plans"].items())
    losses = got["losses"]
    print(f"examples: mg3m_cnn launches {counts}, by direction {by_dir}, "
          f"{wall:.2f} s; {len(losses)} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, accuracy {got['acc']:.3f}; grains "
          f"(fprop/dgrad/wgrad) {picks}")
    mg3m_cnn_oracle(torch, got["plans"])

    old_metrics = obs_metrics.default_metrics()
    old_tracer = obs_trace.default_tracer()
    obs_metrics.set_default_metrics(obs_metrics.MetricRegistry())
    obs_trace.set_default_tracer(obs_trace.Tracer(enabled=True))
    try:
        got, counts, wall = _example(torch, "serve_cnn",
                                     lambda: serve_cnn.main([]))
        sched = got["sched"]
        dump = sched.metrics.dump(os.path.join(tmp, "serve_cnn_metrics.json"),
                                  extra={"drift": sched.drift.snapshot()})
        trace = obs_trace.default_tracer().export(
            os.path.join(tmp, "serve_cnn_trace.json"))
    finally:
        obs_metrics.set_default_metrics(old_metrics)
        obs_trace.set_default_tracer(old_tracer)
    with open(dump) as f:
        report = obsreport.build_report(json.load(f))
    with open(trace) as f:
        spans = obsreport.build_report(json.load(f))
    bursts, over, last = got["stats"]
    slo = report["slo"]
    if (slo["deadline_requests"] != last["deadline_requests"]
            or slo["shed_total"] != last["shed"]):
        raise AssertionError(f"obsreport's slo {slo} disagrees with the "
                             f"scheduler's stats {last}")
    served = {layer for net in sched.nets().values() for layer in net}
    if set(spans.get("layers", {})) != served:
        raise AssertionError(f"the trace report's layers "
                             f"{sorted(spans.get('layers', {}))} are not "
                             f"the served layers {sorted(served)}")
    q = {k: (slo[k]["p50"] * 1e3, slo[k]["p99"] * 1e3)
         for k in ("queue_wait", "dispatch")}
    scenes = ", ".join(f"{n} {sched._layers[n].base.describe()}"
                       for n in sorted(served))
    print(f"examples: serve_cnn launches {counts}, {wall:.2f} s; "
          f"{got['accepted']} accepted (each bitwise equal to per-layer "
          f"B=1 dispatch), {got['shed']} shed; "
          f"deadline misses {last['deadline_misses']}/"
          f"{last['deadline_requests']}, flushes by reason "
          f"{ {k: int(v) for k, v in slo['flushes'].items()} }, "
          f"{last['dispatches']} dispatches, "
          f"mean batch {last['mean_batch']:.2f}, plan misses "
          f"{last['plan_misses']}, builds {last['plan_builds']}; obsreport "
          f"p50/p99 ms queue_wait {q['queue_wait'][0]:.3f}/"
          f"{q['queue_wait'][1]:.3f}, dispatch {q['dispatch'][0]:.3f}/"
          f"{q['dispatch'][1]:.3f}; {len(spans['layers'])} layers traced")
    print(f"  serve_cnn scenes (B=1 members): {scenes}")
    serve_cnn_oracle(torch, sched)
    print(f"examples: the four conv examples took "
          f"{time.perf_counter() - t0:.1f} s")


# ReLU branch flips between the kernels' and F.conv2d's forward of
# mg3m_cnn's first batch, as a share of its 229 376 pre-activations: the
# trunk's FLIP_SHARE would allow none, while a pre-activation within
# FWD_TOL of zero may take either branch (the forward is held to FWD_TOL
# before the flips are counted)
CNN_FLIP_SHARE = 1e-4


def serve_cnn_oracle(torch, sched) -> None:
    """Every served layer's plan at every rung of its ladder (the B=1 plan
    ``assert_parity`` holds the coalesced results to, and each bucket
    plan) on seeded card tensors, against ``kernels.ref.conv_ref``
    (``F.conv2d``, TF32 off): max |err| / max |ref| within
    ``TOL["float32"]``.  ``assert_parity`` compares kernel runs with
    kernel runs, so this is what holds the grains to the oracle at
    alexnet's and resnet's full-width scenes."""
    from repro_torch.kernels.ref import conv_ref

    gen = torch.Generator().manual_seed(0)
    t0, worst, picks, n = time.perf_counter(), (0.0, ""), [], 0
    for name in sorted(sched._layers):
        fam = sched._layers[name]
        rungs = []
        for b in fam.ladder:
            sc = fam.base.with_batch(b)
            plan = sched.registry.get_or_build(sc)
            x = torch.randn(sc.in_shape(), generator=gen).to(fam.flt.device)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                got = plan.execute(x, fam.flt)
                want = conv_ref(x, fam.flt, sc)
            err = ((got - want).abs().max() / want.abs().max()).item()
            if not err <= TOL["float32"]:
                raise AssertionError(
                    f"serve_cnn {name} at B={b} ({plan.schedule}) is "
                    f"{err:.3e} of max |ref| from conv_ref on "
                    f"{sc.describe()} (tol {TOL['float32']})")
            worst, n = max(worst, (err, f"{name} B={b}")), n + 1
            rungs.append(f"{b}:{plan.schedule or 'plain'}")
        picks.append(f"{name} " + " ".join(rungs))
    print(f"  serve_cnn plans vs conv_ref: {n} (layer, bucket) plans, "
          f"max |err| / max |ref| worst "
          f"{worst[0]:.3e} at {worst[1]} (tol {TOL['float32']}); "
          f"{'; '.join(picks)}; {time.perf_counter() - t0:.2f} s")


def mg3m_cnn_oracle(torch, plans, device: str = "cuda") -> None:
    """One step of ``mg3m_cnn`` at its defaults, from its starting
    parameters on its first batch: the loss and every parameter's
    gradient through the plans (the kernels in fprop, dgrad and wgrad)
    against autograd of the same network on ``F.conv2d`` (TF32 off), on
    the kernels' ReLU branches as ``train_grad_oracle`` does.  The
    forward within ``FWD_TOL`` per layer, the loss within
    ``TOL["float32"]`` relative and each gradient within ``GRAD_TOL`` of
    its largest entry."""
    from types import SimpleNamespace

    from repro_torch.examples import mg3m_cnn
    from repro_torch.models.cnn import init_small_cnn

    F = torch.nn.functional
    t0 = time.perf_counter()
    args = mg3m_cnn.parse_args([])
    params = init_small_cnn(torch.Generator().manual_seed(0), device=device)
    xs, ys = mg3m_cnn.make_data(torch.Generator().manual_seed(1), 512,
                                args.res, torch.device(device))
    x, y = xs[:args.batch], ys[:args.batch]
    scenes = {n: t.scene for n, t in plans.items()}
    run = {"plans": plans, "scenes": scenes,
           "state": SimpleNamespace(params=params)}

    def oracle_loss(p, masks):
        z = x.permute(0, 3, 1, 2)
        for name in plans.names():
            sc = scenes[name]
            z = F.conv2d(z, p[name].permute(3, 2, 0, 1),
                         stride=(sc.stdH, sc.stdW), padding=(sc.padH, sc.padW))
            z = z * masks[name]
        lp = F.log_softmax(z.mean(dim=(2, 3)) @ p["head"], dim=-1)
        return -lp.gather(1, y[:, None]).mean()

    def loss_grads(loss_of):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = loss_of(leaves)
        g = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), dict(zip(leaves, g))

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        masks, fwd, flips, n_pre = _forward_branches(
            torch, run, {"images": x}, flip_share=CNN_FLIP_SHARE)
        loss, got = loss_grads(lambda p: mg3m_cnn.loss_fn(p, x, y, plans))
        want_loss, want = loss_grads(lambda p: oracle_loss(p, masks))
    rel = {k: ((got[k] - want[k]).abs().max()
               / want[k].abs().max()).item() for k in want}
    loss_err = abs(loss - want_loss) / abs(want_loss)
    worst = max(rel, key=rel.get)
    print(f"  mg3m_cnn step vs the F.conv2d oracle: loss {loss:.6f} vs "
          f"{want_loss:.6f} (relative {loss_err:.3e}, tol "
          f"{TOL['float32']}); forward max |dz| / max |z| worst "
          f"{max(v[0] for v in fwd.values()):.3e} (tol {FWD_TOL}), {flips} "
          f"ReLU branch flips of {n_pre}; gradients max |dg| / max |g| "
          f"{ {k: float(f'{v:.2e}') for k, v in rel.items()} } (tol "
          f"{GRAD_TOL}); {time.perf_counter() - t0:.2f} s")
    if loss_err > TOL["float32"] or rel[worst] > GRAD_TOL:
        raise AssertionError(f"mg3m_cnn's step through the plans differs "
                             f"from the F.conv2d oracle: loss {loss} vs "
                             f"{want_loss}, gradient of {worst} "
                             f"{rel[worst]:.3e} relative (all: {rel})")


def _f32_bounds(flops: int, nbytes: int) -> dict:
    """The f32 work's bounds: its bytes at 3.35 TB/s against its FLOPs at
    the CUDA cores' f32 rate (67 TFLOP/s) and at a third of the tensor
    cores' TF32 rate (three terms a product, 165 TFLOP/s), ms.  The
    least time the card could take at f32 accuracy is the second."""
    from repro_torch.launch import roofline as R

    bytes_ms = nbytes / R.HBM_BW * 1e3
    xtf32_ms = flops / (PEAK_FLOPS_TF32 / 3) * 1e3
    return {"bound_ms": max(xtf32_ms, bytes_ms),
            "bound_by": "operations" if xtf32_ms >= bytes_ms else "bytes",
            "bound_3xtf32_ms": xtf32_ms,
            "bound_f32_fma_ms": flops / R.PEAK_FLOPS_F32 * 1e3,
            "bytes_ms": bytes_ms, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6}


def _sdpa_backend(torch, q, k, v) -> str:
    """The backend SDPA picks for causal (q, k, v), or "not read"."""
    try:
        return torch.nn.attention.SDPBackend(torch._fused_sdp_choice(
            q, k, v, None, 0.0, True)).name
    except (AttributeError, RuntimeError, TypeError, ValueError):
        return "not read"


def bwd_kernel_ms(torch, runs: dict, calls: int = 3) -> dict:
    """Device ms per call of each backward kernel that each of ``runs``
    (label -> (fn, dtype, D), no two alike in dtype and D) launches: ``dq``
    (flash_bwd_dq*), ``dkdv`` (flash_bwd_dkdv*) and, where the walk is
    split, ``sum`` (the second pass), read by kernel name (its dtype and
    head dim telling the runs apart) under one ``torch.profiler`` session
    over ``calls`` calls of each.  A label's entry is empty unless the
    profiler saw every launch of its dq and dkdv (it drops records in a
    process that ran profiler sessions before)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    by_kernel = {(dtype, d): label for label, (_, dtype, d) in runs.items()}
    assert len(by_kernel) == len(runs), "two runs launch the same kernels"
    for fn, _, _ in runs.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn, _, _ in runs.values():
            for _ in range(calls):
                fn()
        torch.cuda.synchronize()
    out = {label: {} for label in runs}
    seen = {label: {} for label in runs}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or "flash_bwd_d" not in e.key:
            continue
        d = re.search(r"flash_bwd_\w+?(?:<|ILi)(\d+)", e.key)
        label = by_kernel.get(("bfloat16" if "bf16" in e.key else "float32",
                               int(d.group(1)) if d else 0))
        if label is None:
            continue
        part = ("sum" if "dkdv_sum" in e.key else
                "dkdv" if "dkdv" in e.key else "dq")
        out[label][part] = out[label].get(part, 0.0) + \
            e.self_device_time_total / calls / 1e3
        seen[label][part] = seen[label].get(part, 0) + e.count
    for label, parts in seen.items():
        if parts.get("dq") != calls or parts.get("dkdv") != calls \
                or parts.get("sum", calls) != calls:
            print(f"  the profiler saw {parts} launches of {calls} calls: "
                  f"{label}'s backward kernels not measured apart")
            out[label] = {}
    return out


def flash_bwd_split(torch) -> dict:
    """Each backward kernel's device ms (``bwd_kernel_ms``) at the causal
    training shapes, by label: f32 at ``train_lm``'s and the training
    path's flash shapes (``train_lm``, ``training``), bf16 at the training
    path's and zamba2-7b's (``training_bf16``, ``zamba2-7b_bf16``).  Run in
    phase 8, before any other profiler session of the process."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)

    z = get_config(HYBRID_TRAIN_ARCH)
    gen = torch.Generator().manual_seed(29)
    runs, shapes = {}, {}
    for label, (b, s, t, h, hkv, d), dtype in (
            ("train_lm", TRAIN_LM_FLASH, "float32"),
            ("training", TRAIN_FLASH, "float32"),
            ("training_bf16", TRAIN_FLASH, "bfloat16"),
            (f"{z.name}_bf16", (1, LM_TRAIN_SEQ, LM_TRAIN_SEQ, z.n_heads,
                                z.n_kv_heads, z.d_head), "bfloat16")):
        q, k, v, do = (torch.randn(dims, generator=gen).to(
            "cuda", getattr(torch, dtype))
            for dims in ((b * h, s, d), (b * hkv, t, d), (b * hkv, t, d),
                         (b * h, s, d)))
        out, lse = flash_attention_fwd(q, k, v, causal=True,
                                       return_lse=True)
        runs[label] = (functools.partial(flash_attention_bwd, q, k, v, out,
                                         lse, do, causal=True), dtype, d)
        shapes[label] = (f"q {tuple(q.shape)}, k/v {tuple(k.shape)} "
                         f"{dtype} causal")
    split = bwd_kernel_ms(torch, runs)
    for label, parts in split.items():
        print(f"flash_attention_bwd kernels at {shapes[label]} ({label}; "
              f"profiler, by kernel name): " + (", ".join(
                  f"{n} {parts[n]:.4f} ms" for n in ("dq", "dkdv", "sum")
                  if n in parts) or "not measured"))
    del runs
    torch.cuda.empty_cache()
    return split


def flash_f32_rows(torch, launches: int, bwd_launches: int,
                   bwd_split: dict) -> list:
    """The f32 flash kernels at ``train_lm``'s default shape
    (``TRAIN_LM_FLASH``: batch 8, seq 256, 4 heads of 64 over 2 kv heads)
    and at the training path's (``TRAIN_FLASH``: q (16, 4096, 128), k/v
    (2, 4096, 128)), causal, the launches the examples' (phase 16).  The
    ``flash_attention_fwd_f32`` row: ``flash_fwd_kernel`` (device time)
    held within 2e-4 of ``flash_attention_plain`` and ``XTF32_TOL`` of
    ``flash_attention_3xtf32_plain``, bitwise from run to run and with its
    log-sum-exp; the plain version (CUDA events); SDPA in f32 (TF32 off;
    device time, its backend named); the bounds of ``_f32_bounds``.  The
    ``flash_attention_bwd_f32`` row: the f32 backward kernels
    (``flash_attention_bwd``, device time; each kernel's own from phase 8,
    ``bwd_split`` of ``flash_bwd_split``) held within 2e-4 of max |g| of their
    plain version and ``XTF32_BWD_TOL`` of
    ``flash_attention_bwd_3xtf32_plain`` on that forward's output and
    log-sum-exp, the plain version's time, SDPA's backward pinned to the
    memory-efficient kernel (device time: its forward and
    ``torch.autograd.grad`` captured together less its forward), the
    bounds of ``meta.flash_bwd_flops``.  Each row has the ``train_lm``
    shape's numbers at its top level and the training shape's under
    ``"training_shape"``."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain)
    from repro_torch.kernels.meta import flash_bwd_flops, flash_flops

    F = torch.nn.functional
    efficient = torch.nn.attention.SDPBackend.EFFICIENT_ATTENTION
    gen = torch.Generator().manual_seed(19)
    fwd, bwd = {}, {}
    for label, shape in (("train_lm", TRAIN_LM_FLASH),
                         ("training", TRAIN_FLASH)):
        b, s, t, h, hkv, d = shape
        big = label == "training"
        q, kk, v, do = (torch.randn(dims, generator=gen).cuda()
                        for dims in ((b * h, s, d), (b * hkv, t, d),
                                     (b * hkv, t, d), (b * h, s, d)))
        q4, k4, v4 = (x.view(b, -1, x.shape[1], d) for x in (q, kk, v))
        k4, v4 = (x.repeat_interleave(h // hkv, 1) for x in (k4, v4))
        what = f"q {tuple(q.shape)} k {tuple(kk.shape)} ({label} shape)"
        got, lse = flash_attention_fwd(q, kk, v, causal=True,
                                       return_lse=True)
        errs = {}
        _hold(torch, "flash_attention_fwd", "float32", got,
              flash_attention_plain(q, kk, v, causal=True), errs, what)
        _hold_f32_flash(torch, q, kk, v, True, got, errs, what, "xtf32")
        k_ms = device_ms(torch, lambda: flash_attention_fwd(q, kk, v,
                                                            causal=True))
        p_ms = time_ms(torch, lambda: flash_attention_plain(q, kk, v,
                                                            causal=True),
                       iters=3 if big else 20)
        lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True))
        backend = _sdpa_backend(torch, q4, k4, v4)
        nbytes = (q.numel() + kk.numel() + v.numel() + got.numel()) * 4
        fwd[label] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                      "library": f"scaled_dot_product_attention f32 "
                                 f"({backend}; K, V repeated)",
                      "max_abs_err": errs[("flash_attention_fwd",
                                           "float32")],
                      "xtf32_err": errs[("xtf32", "float32")],
                      "shape": f"q ({b * h}, {s}, {d}), k/v ({b * hkv}, "
                               f"{t}, {d}) f32 causal ({label})",
                      **_f32_bounds(flash_flops(b * h, s, t, d, True),
                                    nbytes)}
        # the backward kernels on this forward's output and log-sum-exp
        grads = flash_attention_bwd(q, kk, v, got, lse, do, causal=True)
        _hold_grads(torch, "float32", grads, flash_attention_bwd_plain(
            q, kk, v, got, lse, do, causal=True), errs, what, "bwd")
        _hold_f32_bwd(torch, (q, kk, v, got, lse, do), True, grads, errs,
                      what, "xtf32_bwd")
        b_ms = device_ms(torch, lambda: flash_attention_bwd(
            q, kk, v, got, lse, do, causal=True), iters=5 if big else 20)
        bp_ms = time_ms(torch, lambda: flash_attention_bwd_plain(
            q, kk, v, got, lse, do, causal=True), iters=3 if big else 20)
        leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4)]
        dref = do.view(b, h, s, d)

        def library():
            with torch.enable_grad():
                o = F.scaled_dot_product_attention(*leaves, is_causal=True)
                return torch.autograd.grad(o, leaves, dref)

        with torch.nn.attention.sdpa_kernel(efficient):
            lib_b_ms = device_ms(torch, library, iters=5 if big else 20) \
                - device_ms(torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True), iters=5 if big else 20)
        nbytes = sum(x.numel() * x.element_size()
                     for x in (q, kk, v, got, lse, do, *grads))
        bwd[label] = {"ms": b_ms, "plain_ms": bp_ms, "library_ms": lib_b_ms,
                      "library": "scaled_dot_product_attention's backward "
                                 "f32 (EFFICIENT_ATTENTION; K, V repeated): "
                                 "its forward and backward less its "
                                 "forward",
                      "max_abs_err": errs[("bwd", "float32")],
                      "xtf32_err": errs[("xtf32_bwd", "float32")],
                      "kernel_ms": bwd_split.get(label, {}),
                      "shape": fwd[label]["shape"],
                      **_f32_bounds(flash_bwd_flops(b * h, s, t, d, True),
                                    nbytes)}
        print(f"  flash_attention_fwd_f32 at {fwd[label]['shape']}: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA (f32, {backend}) "
              f"{lib_ms:.4f} ms, bound {fwd[label]['bound_ms']:.4f} ms "
              f"(3xTF32 {fwd[label]['bound_3xtf32_ms']:.4f}, f32 FMA "
              f"{fwd[label]['bound_f32_fma_ms']:.4f}); errors "
              f"{fwd[label]['max_abs_err']:.3e} (plain), "
              f"{fwd[label]['xtf32_err']:.3e} (3xTF32 emulation)")
        print(f"  flash_attention_bwd_f32 at {fwd[label]['shape']}: kernels "
              f"{b_ms:.4f} ms, plain {bp_ms:.4f} ms, SDPA's backward "
              f"(efficient) {lib_b_ms:.4f} ms, bound "
              f"{bwd[label]['bound_ms']:.4f} ms (f32 FMA "
              f"{bwd[label]['bound_f32_fma_ms']:.4f}); "
              f"{bwd[label]['max_abs_err']:.3e} (plain), "
              f"{bwd[label]['xtf32_err']:.3e} (3xTF32 emulation) of max "
              f"|g|")
        del q, kk, v, do, q4, k4, v4, got, lse, grads, leaves, dref
        torch.cuda.empty_cache()
    source, replaces = LM_KERNELS["flash_attention_fwd"]
    rows = []
    for name, parts, n in (("flash_attention_fwd_f32", fwd, launches),
                           ("flash_attention_bwd_f32", bwd, bwd_launches)):
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": n, **parts["train_lm"],
               "training_shape": parts["training"]}
        rows.append(row)
    rows[1]["note"] = ("no TPU kernel of its own: the gradient of "
                       "flash_attention_fwd's function (row "
                       "flash_attention_bwd_train_path)")
    rows[1]["err_of"] = "max |g|"
    return rows


# --------------------------------------------------------------------------
# Shard phase: repro_torch.shard on a 4-shard ring of this one card
# --------------------------------------------------------------------------
SHARD_N = 4                # ring size: (cuda:0,) * 4
SHARD_BUCKET = 8           # the forced partitions' and the timings' batch
SHARD_STEPS = 3            # sharded and one-device train steps compared
# max |loss_sharded - loss_one_device| over the steps: ic partitions sum
# their partials in another order (tests/test_shard.py's 1e-4)
SHARD_LOSS_TOL = 1e-4


def _shard_library(torch, es, inp, flt):
    """One PyTorch call computing the kernel's function on a launched
    (pre-padded) exec-scene operand pair: ``F.conv2d`` with the filter
    dilation on the dense route, ``F.conv_transpose2d`` (the flipped,
    transposed filter) on the lhs-dilated one; returns ``(fn, out)`` with
    ``out`` in the kernels' ``[outH, outW, M, N]`` layout."""
    F = torch.nn.functional
    x = inp.permute(3, 2, 0, 1).contiguous()
    if es.dilH == 1 and es.dilW == 1:
        w = flt.permute(3, 2, 0, 1).contiguous()

        def fn():
            return F.conv2d(x, w, stride=(es.stdH, es.stdW),
                            dilation=(es.fdilH, es.fdilW))
    else:
        w = flt.flip(0, 1).permute(2, 3, 0, 1).contiguous()
        pad = (es.fdilH * (es.fltH - 1) - es.padH,
               es.fdilW * (es.fltW - 1) - es.padW)

        def fn():
            return F.conv_transpose2d(x, w, stride=(es.dilH, es.dilW),
                                      padding=pad,
                                      output_padding=(es.apadH, es.apadW),
                                      dilation=(es.fdilH, es.fdilW))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = fn().permute(2, 3, 1, 0)
    return fn, out


def _shard_operands(torch, scene, op, gen):
    """Seeded f32 operands of one (forward scene, op) on the card, scaled
    so the exec conv's outputs are O(1)."""
    shapes = {"fprop": (scene.in_shape(), scene.flt_shape()),
              "dgrad": (scene.out_shape(), scene.flt_shape()),
              "wgrad": (scene.in_shape(), scene.out_shape())}[op]
    fan = {"fprop": scene.fltH * scene.fltW * scene.IC,
           "dgrad": scene.fltH * scene.fltW * scene.OC,
           "wgrad": scene.outH * scene.outW * scene.B}[op]
    return (torch.randn(shapes[0], generator=gen).cuda(),
            (torch.randn(shapes[1], generator=gen) * fan ** -0.5).cuda())


def shard_forced(torch, ring, chain):
    """Every trunk layer at ``SHARD_BUCKET``, every op, every axis feasible
    at ``SHARD_N``: the pinned partition (the selector's grain for its
    sub-scene) against the one-device plan on the same operands — batch,
    oc and h bitwise, ic within rtol=atol=1e-4.  A grain no sub-scene
    picks is then forced on the first sub-scene it fits.  Returns the
    plans and the launched (plan, operands) pairs."""
    from repro_torch.core.mapping import select_schedule, smem_budget
    from repro_torch.plan import ConvOp, make_plan
    from repro_torch.shard import (PARTITION_AXES, make_sharded_plan,
                                   pinned_shard_spec, shard_blocker,
                                   shard_sub_scene)
    from repro_torch.shard.plan import _exec_scene_for

    gen = torch.Generator().manual_seed(21)
    budget = smem_budget("cuda")
    plans, launched, blocked, worst_ic = [], [], [], 0.0
    cases = []
    for name, sc0 in chain.items():
        sc = sc0.with_batch(SHARD_BUCKET)
        for op in ("fprop", "dgrad", "wgrad"):
            ex, _ = _exec_scene_for(sc, ConvOp(op))
            for axis in PARTITION_AXES:
                why = shard_blocker(ex, axis, SHARD_N)
                if why:
                    blocked.append(f"{name}/{op}/{axis} ({why})")
                else:
                    cases.append((name, sc, op, ex, axis))

    def sub_launches():
        # sub-scene launches by grain: n_shards per sharded execute (the
        # one-device plans these are held against launch kernels too)
        counts = {"TB11": 0, "TB18": 0, "TB88": 0}
        for p in plans:
            counts[p.schedule] += p.n_shards
        return counts

    def run(name, sc, op, axis, choice, a, b, one):
        spec = pinned_shard_spec(sc, op, axis, SHARD_N, choice)
        plan = make_sharded_plan(sc, op, devices=ring, spec=spec)
        got = plan.execute(a, b)
        if axis == "ic":
            if not torch.allclose(got, one, rtol=1e-4, atol=1e-4):
                raise AssertionError(
                    f"{name} {op} ic:{SHARD_N} differs from the one-device "
                    f"plan by {(got - one).abs().max().item():.3e}")
            err = (got - one).abs().max().item()
        elif not torch.equal(got, one):
            raise AssertionError(
                f"{name} {op} {axis}:{SHARD_N} ({choice.schedule}) is not "
                f"bitwise the one-device plan: max abs diff "
                f"{(got - one).abs().max().item():.3e}")
        else:
            err = 0.0
        plans.append(plan)
        launched.append((plan, a, b))
        return err

    t0 = time.perf_counter()
    ones = {}
    for name, sc, op, ex, axis in cases:
        if (name, op) not in ones:
            a, b = _shard_operands(torch, sc, op, gen)
            ones[(name, op)] = (a, b, make_plan(sc, op).execute(a, b))
        a, b, one = ones[(name, op)]
        sub = shard_sub_scene(ex, axis, SHARD_N)
        err = run(name, sc, op, axis, select_schedule(sub, budget=budget),
                  a, b, one)
        worst_ic = max(worst_ic, err)
    counts = sub_launches()
    forced = []
    for grain in ("TB11", "TB18", "TB88"):
        if counts[grain]:
            continue
        for name, sc, op, ex, axis in cases:
            try:
                choice = select_schedule(shard_sub_scene(ex, axis, SHARD_N),
                                         allowed=(grain,), budget=budget)
            except ValueError:
                continue
            a, b, one = ones[(name, op)]
            run(name, sc, op, axis, choice, a, b, one)
            forced.append(f"{grain} on {name} {op} {axis}:{SHARD_N}")
            break
        else:
            print(f"  {grain} fits no sub-scene of the trunk at bucket "
                  f"{SHARD_BUCKET} over {SHARD_N} shards")
    torch.cuda.synchronize()
    counts = sub_launches()
    grains = {}
    for p in plans:
        key = f"{p.op.value}/{p.spec.axis}"
        grains.setdefault(key, {}).setdefault(p.schedule, 0)
        grains[key][p.schedule] += 1
    print(f"shard forced partitions: {len(plans)} plans over the trunk at "
          f"bucket {SHARD_BUCKET} on a ring of {SHARD_N} x {ring[0]}, "
          f"batch/oc/h bitwise equal to the one-device plans, ic within "
          f"1e-4 (max abs err {worst_ic:.3e}); "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"  grains of the sub-scenes by (op/axis): {grains}")
    print(f"  sub-scene launches by grain {counts}"
          + (f"; selector never picked, so forced: {forced}"
             if forced else ""))
    print(f"  blocked (layer/op/axis): {len(blocked)}: {blocked}")
    for grain in ("TB11", "TB18", "TB88"):
        if not counts[grain]:
            print(f"  {grain} launched on no sub-scene (see above)")
    return plans, launched


def shard_serve(torch, ring, chain, weights, tmp):
    """``ConvServer(mesh=make_mesh_for(SHARD_N, 1, devices=ring))`` over
    the trunk's layers at buckets 1-8, strict, beside the one-device
    server on the same requests: outputs bitwise equal, zero plan misses
    and builds after prewarm.  When the selector keeps every bucket
    unsharded, a second mesh server is prewarmed from a registry artifact
    of pinned ``batch:4`` plans (buckets 4 and 8) and held the same way.
    Returns the mesh servers and their kernel launches by grain."""
    from repro_torch.core.mapping import select_schedule, smem_budget
    from repro_torch.kernels import mg3m_conv as K
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.plan import ConvOp, PlanRegistry
    from repro_torch.serve.conv import ConvRequest, server_from_scenes
    from repro_torch.shard import assemble_sharded_plan, shard_sub_scene

    t0 = time.perf_counter()
    kw = dict(max_batch=SHARD_BUCKET, strict=True, ladder_slack=0.0)
    mesh = make_mesh_for(SHARD_N, 1, devices=ring)
    scenes = {name: sc.with_batch(1) for name, sc in chain.items()}
    gen = torch.Generator().manual_seed(22)
    xs = [(name, torch.randn(sc.in_shape()[:3] + (b,), generator=gen))
          for name, sc in scenes.items() for b in (1, 2, 4, 8)]

    def serve(server):
        return server.serve([ConvRequest(rid=i, layer=name, x=x)
                             for i, (name, x) in enumerate(xs)])

    one = server_from_scenes(scenes, weights, device="cuda", **kw)
    one.prewarm(compile=True)
    want = serve(one)
    launches = {"TB11": 0, "TB18": 0, "TB88": 0}

    def check(server, what, artifact=None):
        torch.cuda.synchronize()
        before = K.launch_counts()
        built = server.prewarm(artifact=artifact, compile=True)
        snap = server.snapshot()
        got = serve(server)
        torch.cuda.synchronize()
        for g, n in K.launch_counts().items():
            launches[g] += n - before[g]
        st = server.stats(since=snap)
        bad = [i for i, (g, w) in enumerate(zip(got, want))
               if not torch.equal(g, w)]
        if bad:
            raise AssertionError(f"{what}: requests {bad} differ from the "
                                 f"one-device server's")
        if st["plan_misses"] or st["plan_builds"]:
            raise AssertionError(f"{what}: post-warm plan misses/builds "
                                 f"{st}")
        tags = {}
        for (name, _, b), tag in sorted(server._shard_tags.items()):
            tags.setdefault(name, {})[b] = tag
        print(f"  {what}: {len(xs)} requests in {st['dispatches']} "
              f"dispatches bitwise equal to the one-device server's, 0 "
              f"plan misses and builds after a prewarm that built {built}; "
              f"partition by (layer, bucket):")
        for name, by_b in tags.items():
            print(f"    {name}: {by_b}")
        return tags

    served = server_from_scenes(scenes, weights, mesh=mesh, **kw)
    tags = check(served, "mesh server (the selector's partitions)")
    servers = [served]
    if all(t == "none:1" for by_b in tags.values() for t in by_b.values()):
        print("  the selector kept every bucket unsharded: a second mesh "
              "server is prewarmed from an artifact of pinned batch:4 plans")
        reg = PlanRegistry(device="cuda")
        budget = smem_budget("cuda")
        for sc in scenes.values():
            for b in (4, 8):
                scene = sc.with_batch(b)
                choice = select_schedule(
                    shard_sub_scene(scene, "batch", SHARD_N), budget=budget)
                reg.put(assemble_sharded_plan(scene, ConvOp.FPROP,
                                              "analytic", "batch", SHARD_N,
                                              choice, devices=ring))
        path = reg.save(os.path.join(tmp, "shard_plans.json"))
        pinned = server_from_scenes(scenes, weights, mesh=mesh, **kw)
        tags = check(pinned, "mesh server (pinned batch:4 artifact)",
                     artifact=path)
        if not any(t == f"batch:{SHARD_N}" for by_b in tags.values()
                   for t in by_b.values()):
            raise AssertionError("the artifact's batch:4 plans were not "
                                 "served")
        servers.append(pinned)
    else:
        print("  the selector sharded some buckets: no artifact server")
    print(f"shard serving: {time.perf_counter() - t0:.1f} s; launches of "
          f"the mesh servers {launches}")
    return servers, launches


def _trunk_train(torch, plans, scenes, steps):
    """``steps`` steps of phase 6's trainer (global batch 16 in 2
    microbatches, f32, AdamW) over ``plans`` from seed-0 parameters on
    the stream's batch 0; returns the losses."""
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.models.cnn import init_cnn_from_scenes
    from repro_torch.train import cnn as tc
    from repro_torch.train.optimizer import AdamWConfig

    params = init_cnn_from_scenes(torch.Generator().manual_seed(0), scenes,
                                  device="cuda")
    cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)
    step = tc.jit_train_step(tc.build_cnn_train_step(
        plans, cfg, n_microbatches=TRAIN_N_MB,
        buckets=tc.make_grad_buckets(params), layer_order=plans.names()))
    state = tc.init_train_state(params)
    data = SyntheticImages(TRAIN_MB * TRAIN_N_MB,
                           scenes[f"{TRAIN_NET}/L0"].inH, 3, 10, seed=0,
                           noise=0.3)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch_at(0).items()}
    losses = []
    with tc.resolution_guard():
        for _ in range(steps):
            _, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
    return losses


def shard_train(torch, ring):
    """``make_model_plans(trunk, devices=ring)`` trained ``SHARD_STEPS``
    steps by phase 6's trainer, beside a one-device run on the same
    parameters and data: losses within ``SHARD_LOSS_TOL``, and each
    grain's launches equal to what the sharded plans route to it (every
    direction but the first layer's dgrad, ``n_shards`` launches per
    dispatch).  Returns the sharded plans, the one-device run's and the
    launch counts."""
    from repro_torch.core.autodiff import make_model_plans
    from repro_torch.kernels import mg3m_conv as K
    from repro_torch.models.cnn import cnn_chain_scenes
    from repro_torch.plan import PlanRegistry

    t0 = time.perf_counter()
    scenes = cnn_chain_scenes(TRAIN_NET, TRAIN_MB)
    plans = make_model_plans(scenes, devices=ring)
    plan_s = time.perf_counter() - t0
    one = make_model_plans(scenes, registry=PlanRegistry(device="cuda"))
    torch.cuda.synchronize()
    before = K.launch_counts()
    losses = _trunk_train(torch, plans, scenes, SHARD_STEPS)
    torch.cuda.synchronize()
    after = K.launch_counts()
    counts = {g: after[g] - before[g] for g in after}
    want_losses = _trunk_train(torch, one, scenes, SHARD_STEPS)
    diff = max(abs(a - b) for a, b in zip(losses, want_losses))
    if not all(map(math.isfinite, losses)) or diff > SHARD_LOSS_TOL:
        raise AssertionError(f"sharded losses {losses} vs one-device "
                             f"{want_losses}: max diff {diff:.3e}")
    first = plans.names()[0]
    want = {g: 0 for g in counts}
    for name, op, plan in plans.plans():
        if (name, op) != (first, "dgrad"):
            want[plan.schedule] += (plan.n_shards * SHARD_STEPS
                                    * TRAIN_N_MB)
    if counts != want:
        raise AssertionError(f"sharded training launched {counts}, the "
                             f"plans route {want}")
    print(f"shard training: {len(scenes)} layers x 3 sharded plans over "
          f"{SHARD_N} x {ring[0]} built in {plan_s:.2f} s; {SHARD_STEPS} "
          f"steps at global batch {TRAIN_MB * TRAIN_N_MB} in {TRAIN_N_MB} "
          f"microbatches, losses {losses} vs one-device {want_losses} "
          f"(max diff {diff:.3e}, tol {SHARD_LOSS_TOL}); launches {counts} "
          f"= the plans' routing; {time.perf_counter() - t0:.1f} s")
    for name, triple in plans.items():
        print(f"  {name}: " + "; ".join(
            f"{p.op.value} {p.shard_tag} {p.schedule}" for p in
            (triple.fprop, triple.dgrad, triple.wgrad)))
    return plans, counts


def shard_times(torch, ring, chain):
    """Per trunk layer at ``SHARD_BUCKET``: the pinned ``batch:4`` fprop
    dispatch and the one-device plan's, CUDA events around back-to-back
    calls (host included), and the four shards' kernels' device time.
    The launch overhead of the ring's dispatch is the sharded time less
    its shards' device time (median over the layers); a collective round
    on this one-card ring is one device copy launch (a 16 KiB copy, host
    included).  Returns both in seconds."""
    from repro_torch.core.mapping import select_schedule, smem_budget
    from repro_torch.plan import make_plan
    from repro_torch.shard import (make_sharded_plan, pinned_shard_spec,
                                   shard_sub_scene)

    gen = torch.Generator().manual_seed(23)
    budget = smem_budget("cuda")
    over = []
    for name, sc0 in chain.items():
        sc = sc0.with_batch(SHARD_BUCKET)
        choice = select_schedule(shard_sub_scene(sc, "batch", SHARD_N),
                                 budget=budget)
        plan = make_sharded_plan(sc, devices=ring, spec=pinned_shard_spec(
            sc, "fprop", "batch", SHARD_N, choice))
        one = make_plan(sc)
        a, b = _shard_operands(torch, sc, "fprop", gen)
        s_ms = time_ms(torch, lambda: plan.execute(a, b))
        o_ms = time_ms(torch, lambda: one.execute(a, b))
        k_ms = sum(device_ms(torch, lambda: fn(inp, flt, plan.inner
                                               .exec_scene, **blocks))
                   for fn, inp, flt, blocks in plan.kernel_calls(a, b))
        fn, inp, flt, blocks = one.kernel_call(a, b)
        ok_ms = device_ms(torch, lambda: fn(inp, flt, one.exec_scene,
                                            **blocks))
        over.append(s_ms - k_ms)
        print(f"  {name} B={SHARD_BUCKET}: batch:{SHARD_N} ({plan.schedule})"
              f" {s_ms:.4f} ms, shards' kernels {k_ms:.4f} ms (device); "
              f"one-device ({one.schedule}) {o_ms:.4f} ms, kernel "
              f"{ok_ms:.4f} ms")
    x = torch.zeros(4096, device="cuda")
    copy_ms = time_ms(torch, lambda: x.clone(), iters=200)
    over_ms = sorted(over)[len(over) // 2]
    print(f"shard times: launch overhead of a {SHARD_N}-way dispatch "
          f"(sharded ms less its shards' device ms, median of "
          f"{len(over)} layers) {over_ms * 1e3:.1f} us "
          f"(range {min(over) * 1e3:.1f}-{max(over) * 1e3:.1f}); one "
          f"16 KiB device copy {copy_ms * 1e3:.2f} us (host included); "
          f"no speed is claimed: the {SHARD_N} shards share one card")
    return over_ms / 1e3, copy_ms / 1e3


def shard_rows(torch, launched, counts, errs):
    """The ``<grain>_shard_path`` rows: per grain, its longest sub-scene
    launch of the phase (device time of every distinct launch, 5 replays),
    timed in full beside its plain version, its bound and one PyTorch call
    for the same function; ``launches`` from the served and trained runs
    of the phase."""
    from repro_torch.kernels.mg3m_conv import conv_plain
    from repro_torch.launch import roofline as R

    seen = {}
    for plan, a, b in launched:
        es = plan.inner.exec_scene
        for fn, inp, flt, blocks in plan.kernel_calls(a, b)[:1]:
            key = (es, plan.choice)
            if key not in seen:
                ms = device_ms(torch, lambda: fn(inp, flt, es, **blocks),
                               iters=5)
                seen[key] = (ms, plan, fn, inp, flt, blocks)
    rows = []
    for grain in ("TB11", "TB18", "TB88"):
        mine = [v for v in seen.values() if v[1].schedule == grain]
        if not mine:
            continue
        _, plan, fn, inp, flt, blocks = max(mine, key=lambda v: v[0])
        es = plan.inner.exec_scene
        got = fn(inp, flt, es, **blocks)
        t = time.perf_counter()
        want = conv_plain(inp, flt, es, blocks.get("seg_taps", 0))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=TOL["float32"],
                              atol=TOL["float32"]):
            raise AssertionError(f"{plan.describe()}'s shard kernel "
                                 f"disagrees with its plain version "
                                 f"(max abs err {err})")
        lib, lib_out = _shard_library(torch, es, inp, flt)
        lib_err = (lib_out[:, :, :got.shape[2], :got.shape[3]]
                   - got).abs().max().item()
        if lib_err > 1e-3 * max(1.0, got.abs().max().item()):
            raise AssertionError(f"the PyTorch yardstick of {es.describe()} "
                                 f"is not the kernel's function "
                                 f"({lib_err:.3e})")
        errs[(grain, "float32")] = max(errs.get((grain, "float32"), 0.0),
                                       err)
        k_ms = device_ms(torch, lambda: fn(inp, flt, es, **blocks))
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            lib_ms = device_ms(torch, lib)
        nbytes = 4 * (inp.numel() + flt.numel() + got.numel())
        ops_ms = es.flops / R.PEAK_FLOPS_F32 * 1e3
        bytes_ms = nbytes / R.HBM_BW * 1e3
        library = "F.conv2d" if es.dilH == es.dilW == 1 else \
            "F.conv_transpose2d"
        print(f"  {grain} shard path: {plan.describe()} sub-scene "
              f"{es.describe()}: kernel {k_ms:.4f} ms, plain "
              f"{plain_ms:.1f} ms, {library} {lib_ms:.4f} ms, bound "
              f"{max(ops_ms, bytes_ms):.4f} ms")
        rows.append({
            "name": f"mg3m_{grain.lower()}_shard_path", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES[grain],
            "launches": counts[grain], "max_abs_err": err,
            "ms": k_ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms, "library": library,
            "shape": f"the longest of {len(mine)} {grain} sub-scene "
                     f"launches of the shard phase: {plan.describe()} "
                     f"shard {es.describe()}",
            "gflop": es.flops / 1e9, "mbytes": nbytes / 1e6})
    return rows


def shard_phase(torch, tmp, errs):
    """Phase 17: the conv sharding layer on a ring of ``SHARD_N`` x the
    card: forced partitions, mesh serving and sharded training (their
    kernel launches counted from 0, the one-device runs they are held
    against left out), the verifier on every sharded plan, the dispatch
    times; returns the ``<grain>_shard_path`` rows."""
    from repro_torch.analysis import verify as V
    from repro_torch.models.cnn import cnn_chain_scenes

    t0 = time.perf_counter()
    ring = (torch.device("cuda", 0),) * SHARD_N
    chain = cnn_chain_scenes("resnet")
    weights = he_weights(torch, chain)
    forced, launched = shard_forced(torch, ring, chain)
    servers, serve_counts = shard_serve(torch, ring, chain, weights, tmp)
    plans, train_counts = shard_train(torch, ring)
    counts = {g: serve_counts[g] + train_counts[g] for g in serve_counts}
    for grain in ("TB11", "TB18", "TB88"):
        if not counts[grain]:
            print(f"  {grain}: no launch while serving or training sharded "
                  f"(its row counts 0)")
    sharded = list(forced) + [p for s in servers
                              for p in s.registry.plans().values()]
    sharded += [p for _, _, p in plans.plans() if p.shard_tag]
    findings = []
    for plan in sharded:
        findings += V.verify_sharded_plan(plan, device="cuda")
    bad = V.errors(findings)
    if bad:
        raise AssertionError(f"{len(bad)} error findings on sharded plans: "
                             f"{[f.message for f in bad[:4]]}")
    print(f"shard verify: {len(sharded)} sharded plans, 0 errors "
          f"({len(findings)} warnings)")
    over_s, round_s = shard_times(torch, ring, chain)
    rows = shard_rows(torch, launched, counts, errs)
    print(f"shard phase: {time.perf_counter() - t0:.1f} s; launches while "
          f"serving and training sharded {counts}; measured "
          f"SHARD_LAUNCH_OVERHEAD_S {over_s:.3e}, ICI_LATENCY_S "
          f"{round_s:.3e}")
    return rows


# --------------------------------------------------------------------------
# The LM path on a mesh: parallel/ring.py over rings of this one card
# --------------------------------------------------------------------------
MESH_RING = 4              # (cuda:0,) * 4: the (2, 2), (4, 1), (1, 4) rings
MESH_SEQ = LM_TRAIN_SEQ    # train_4k's 4096
MESH_BATCH = 4             # the train runs' global batch (train_4k's 256)
MESH_STEPS = 3
TP_ARCH = "qwen3-14b"
TP_LAYERS = 4              # qwen3-14b's 40 layers cut to 4 for one card
# relative, the TP grain's against one device's: its row-parallel partial
# sums are rounded to bf16 before they are summed.  On an H100 the losses
# read 1.16e-05 and the gradient norms 2.57e-04; a dropped or doubled
# partial moves either far more
TP_LOSS_TOL = 1e-3
TP_NORM_TOL = 5e-3
ELASTIC_LAYERS = 2         # the elastic restore's qwen2.5-3b, depth cut
ELASTIC_SEQ = 1024         # and its sequence (its checkpoints hold 5.6 GB)
MESH_PROMPT = 2048
MESH_NEW = 8
# the flash kernel at a TP shard of qwen3-14b: one microbatch, 40 / 2 q
# heads over 8 / 2 k/v heads, seq 4096, D = 128 (bf16, causal)
TP_FLASH = (1, MESH_SEQ, MESH_SEQ, 20, 4, 128)


def _flash_bwd_calls() -> int:
    from repro_torch.kernels.flash_attention import FlashAttention
    return FlashAttention.backward_calls


def _held_flash_bwd(label: str, counts: dict, calls: int) -> None:
    """A ring's training steps ran ``FlashAttention``'s backward ``calls``
    times: at least once, each launching the backward kernels once."""
    if not calls or counts["flash_attention_bwd"] != calls:
        raise AssertionError(f"{label}: FlashAttention's backward ran "
                             f"{calls} times and launched the backward "
                             f"kernels {counts['flash_attention_bwd']} times")


def _ring_devices(torch, n):
    return (torch.device("cuda", 0),) * n


def _timed_steps(torch, step, state, batches):
    """Each batch through ``step``: (losses as floats, ms per step by CUDA
    events, gradient norms as floats)."""
    losses, ms, norms = [], [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, m = step(state, batch)
        end.record()
        end.synchronize()
        losses.append(float(m["loss"]))
        ms.append(start.elapsed_time(end))
        norms.append(float(m["grad_norm"]))
    return losses, ms, norms


def _coll_delta(before) -> dict:
    from repro_torch.parallel import sharding as SH
    return {k: v - before[k] for k, v in SH.collective_bytes().items()}


def _park(torch, rstate):
    """A ring state's global leaves: the parameters gathered on the card,
    the moments in pinned host memory (a function, so that nothing of the
    ring state outlives it)."""
    glob = rstate.global_state(device="cuda")
    params = {n: leaf() for n, leaf in glob.params.items()}
    leaves = {(which, n): leaf for which in ("m", "v")
              for n, leaf in getattr(glob.opt, which).items()}
    dtype = rstate.opt[0].m[next(iter(params))].dtype
    # one pinned buffer: one page-locking call, not one per leaf
    flat = torch.empty(sum(math.prod(x.shape) for x in leaves.values()),
                       dtype=dtype, pin_memory=True)
    moments, at = {}, 0
    for key, leaf in leaves.items():
        n = math.prod(leaf.shape)
        moments[key] = flat[at:at + n].view(leaf.shape).copy_(leaf())
        at += n
    return params, moments


def mesh_dp(torch, np) -> dict:
    """qwen2.5-3b at full width (bf16, seq 4096) in the DP grain on a
    (2, 2) ring of this card: ``MESH_STEPS`` steps at global batch 4 (one
    sequence per position) against the one-device step at global batch 4
    in 4 microbatches of 1 from the same seeded weights.  Losses and every
    parameter and moment after the last step must be bitwise equal.  The
    ring runs first; its gathered parameters stay on the card and its
    moments wait in pinned host memory while one device runs (the two
    states and one step's transients do not fit on the card together)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh, make_mesh_for
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import ctx, ring
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import optimizer as O
    from repro_torch.train import step as S

    cfg = get_config(DENSE_ARCH)
    mesh = make_mesh_for(2, 2, devices=_ring_devices(torch, MESH_RING))
    plan = dataclasses.replace(S.default_plan(cfg, "train_4k", mesh),
                               n_microbatches=1)
    if plan.tp:
        raise AssertionError(f"{cfg.name}: default_plan picked the TP grain")
    opt_cfg = O.AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=1, total_steps=100)
    data = SyntheticLM(cfg.vocab, MESH_BATCH, MESH_SEQ, seed=2)
    batches = [S.to_device(data.batch_at(i), "cuda")
               for i in range(MESH_STEPS)]
    base = torch.cuda.memory_allocated()
    model = init_params(cfg, seed=0, trainable=True)
    rstate = ring.init_state(model, mesh, tp=False)
    del model
    torch.cuda.empty_cache()
    step, hooks = S.build_train_step(cfg, mesh, opt_cfg, plan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_lm_counts()
    f0 = _flash_bwd_calls()
    coll0 = SH.collective_bytes()
    with ctx.activation_sharding(hooks):
        got, ms, got_norms = _timed_steps(torch, step, rstate, batches)
    counts = _lm_counts()
    _held_flash_bwd(f"{cfg.name} ring", counts, _flash_bwd_calls() - f0)
    coll = {k: v // MESH_STEPS for k, v in _coll_delta(coll0).items()}
    peak = torch.cuda.max_memory_allocated() - base
    if not counts["flash_attention_fwd"]:
        raise AssertionError("the DP ring launched no flash kernel")
    split = ring.replica_mismatches(rstate)
    if split:
        raise AssertionError(f"replicated leaves' copies differ on the DP "
                             f"ring: {split[:6]}")
    t0 = time.perf_counter()
    params, moments = _park(torch, rstate)
    del rstate, step
    torch.cuda.empty_cache()
    park_s = time.perf_counter() - t0
    model = init_params(cfg, seed=0, trainable=True)
    state = S.init_train_state(model)
    step1, _ = S.build_train_step(
        cfg, make_host_mesh(), opt_cfg,
        dataclasses.replace(plan, n_microbatches=mesh.size), model)
    torch.cuda.reset_peak_memory_stats()
    want, ms1, want_norms = _timed_steps(torch, step1, state, batches)
    peak1 = torch.cuda.max_memory_allocated() - base
    if got != want or got_norms != want_norms:
        raise AssertionError(f"{cfg.name} DP (2, 2) ring losses {got} and "
                             f"gradient norms {got_norms} != one device's "
                             f"{want} and {want_norms}")
    t0 = time.perf_counter()
    bad = [n for n, p in model.named_parameters()
           if not torch.equal(params[n], p.detach())]
    for (which, n), host in moments.items():
        if not torch.equal(getattr(state.opt, which)[n],
                           host.to("cuda", non_blocking=True)):
            bad.append((which, n))
    if bad:
        raise AssertionError(f"{len(bad)} leaves of the DP ring differ "
                             f"from one device's: {bad[:6]}")
    compare_s = park_s + time.perf_counter() - t0
    del model, state, step1, params, moments
    torch.cuda.empty_cache()
    one, r = float(np.median(ms1)), float(np.median(ms))
    print(f"  {cfg.name} DP grain, (2, 2) ring of this card, global batch "
          f"{MESH_BATCH} x {MESH_SEQ}: losses {got} and gradient norms "
          f"{got_norms} bitwise equal to one "
          f"device's (4 microbatches of 1), every parameter and moment "
          f"bitwise equal after {MESH_STEPS} steps; step {r:.1f} ms "
          f"({[round(x, 1) for x in ms]}) against one device's {one:.1f} ms "
          f"({[round(x, 1) for x in ms1]}): ring host cost {r - one:.1f} ms "
          f"per step; peak memory {peak / 1e9:.2f} GB (one device "
          f"{peak1 / 1e9:.2f} GB); collective bytes per step {coll}; flash "
          f"launched {counts['flash_attention_fwd']} times; moving the "
          f"ring's leaves aside and comparing {compare_s:.1f} s")
    return {"ms": r, "one_ms": one, "peak": peak, "coll": coll,
            "launches": counts["flash_attention_fwd"]}


def _tp_reduced_oracle(torch) -> float:
    """Reduced qwen3-14b (f32) in the TP + SP grain on a (2, 2) ring of
    this card: the gradients within ``LM_GRAD_TOL`` of max |g| per leaf of
    the one-device step's, and one update within it where the gradient's
    sign is fixed (2 lr elsewhere: Adam's first step moves each element by
    about lr * sign(g)).  Returns the largest gradient error."""
    import dataclasses
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.launch.mesh import make_host_mesh, make_mesh_for
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import ring
    from repro_torch.train import optimizer as O
    from repro_torch.train import step as S

    cfg = reduced(get_config(TP_ARCH))
    mesh = make_mesh_for(2, 2, devices=_ring_devices(torch, MESH_RING))
    gen = torch.Generator().manual_seed(21)
    batch = {k: torch.randint(0, cfg.vocab, (4, 64), generator=gen).cuda()
             for k in ("tokens", "labels")}
    opt_cfg = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    plan = S.StepPlan(n_microbatches=1, tp=True)
    model = init_params(cfg, seed=3, trainable=True)
    rstate = ring.init_state(model, mesh, tp=True)
    one = S.init_train_state(model)
    gstep, _ = S.build_train_step(cfg, mesh, opt_cfg,
                                  dataclasses.replace(plan, skip_update=True))
    got = ring.gather_grads(rstate.params, gstep(rstate, batch)[1]["grads"],
                            "cuda")
    ostep, _ = S.build_train_step(cfg, make_host_mesh(), opt_cfg,
                                  S.StepPlan(n_microbatches=2,
                                             skip_update=True), model)
    want = ostep(one, batch)[1]["grads"]
    worst = 0.0
    for n, g in want.items():
        err = ((got[n] - g).abs().max() / g.abs().max()).item()
        worst = max(worst, err)
        if not err <= LM_GRAD_TOL:
            raise AssertionError(f"TP ring gradient of {n}: {err} of max "
                                 f"|g| (tol {LM_GRAD_TOL})")
    step, _ = S.build_train_step(cfg, mesh, opt_cfg, plan)
    _, m = step(rstate, batch)
    ostep, _ = S.build_train_step(cfg, make_host_mesh(), opt_cfg,
                                  S.StepPlan(n_microbatches=2), model)
    ostep(one, batch)
    lr = float(m["lr"])
    glob = rstate.global_state(device="cuda")
    for n, p in model.named_parameters():
        err = (glob.params[n]() - p.detach()).abs()
        firm = want[n].abs() > LM_GRAD_TOL * want[n].abs().max()
        if not (err[firm].max().item() if firm.any() else 0.0) \
                <= LM_GRAD_TOL or not err.max().item() <= 2 * lr + \
                LM_GRAD_TOL:
            raise AssertionError(f"TP ring update of {n} off the one-device "
                                 f"update by {err.max().item()}")
    return worst


def mesh_tp(torch, np) -> dict:
    """qwen3-14b at full width, its depth cut to ``TP_LAYERS``, in the TP +
    SP grain (``default_plan``: d_model 5120) on a (2, 2) ring of this
    card: ``MESH_STEPS`` steps at global batch 4 (2 per data row in 2
    microbatches of 1) against the one-device step (4 microbatches of 1),
    losses within ``TP_LOSS_TOL`` and gradient norms (the TP grain's:
    per-shard sums and a scalar all-reduce) within ``TP_NORM_TOL``; the
    flash kernel runs at the shard's
    20 q heads over 4 k/v heads.  Then the reduced f32 copy's oracle."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh, make_mesh_for
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import ctx, ring
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import optimizer as O
    from repro_torch.train import step as S

    cfg = dataclasses.replace(get_config(TP_ARCH), n_layers=TP_LAYERS)
    mesh = make_mesh_for(2, 2, devices=_ring_devices(torch, MESH_RING))
    plan = dataclasses.replace(S.default_plan(cfg, "train_4k", mesh),
                               n_microbatches=2)
    if not (plan.tp and plan.seq_shard_activations):
        raise AssertionError(f"{cfg.name}: default_plan did not pick TP + SP")
    opt_cfg = O.AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=1, total_steps=100)
    data = SyntheticLM(cfg.vocab, MESH_BATCH, MESH_SEQ, seed=3)
    batches = [S.to_device(data.batch_at(i), "cuda")
               for i in range(MESH_STEPS)]
    base = torch.cuda.memory_allocated()
    model = init_params(cfg, seed=0, trainable=True)
    state = S.init_train_state(model)
    step1, _ = S.build_train_step(cfg, make_host_mesh(), opt_cfg,
                                  S.StepPlan(n_microbatches=MESH_BATCH),
                                  model)
    want, ms1, want_norms = _timed_steps(torch, step1, state, batches)
    del model, state, step1
    torch.cuda.empty_cache()
    model = init_params(cfg, seed=0, trainable=True)
    rstate = ring.init_state(model, mesh, tp=True)
    del model
    torch.cuda.empty_cache()
    step, hooks = S.build_train_step(cfg, mesh, opt_cfg, plan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_lm_counts()
    f0 = _flash_bwd_calls()
    coll0 = SH.collective_bytes()
    with ctx.activation_sharding(hooks):
        got, ms, got_norms = _timed_steps(torch, step, rstate, batches)
    counts = _lm_counts()
    _held_flash_bwd(f"{cfg.name} ring", counts, _flash_bwd_calls() - f0)
    coll = {k: v // MESH_STEPS for k, v in _coll_delta(coll0).items()}
    peak = torch.cuda.max_memory_allocated() - base
    split = ring.replica_mismatches(rstate)
    del rstate
    torch.cuda.empty_cache()
    if split:
        raise AssertionError(f"replicated leaves' copies differ on the TP "
                             f"ring: {split[:6]}")
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    if not max(rel) <= TP_LOSS_TOL:
        raise AssertionError(f"{cfg.name} TP ring losses {got} against one "
                             f"device's {want}: {rel} (tol {TP_LOSS_TOL})")
    rel_n = [abs(g - w) / abs(w) for g, w in zip(got_norms, want_norms)]
    if not max(rel_n) <= TP_NORM_TOL:
        raise AssertionError(f"{cfg.name} TP ring gradient norms "
                             f"{got_norms} against one device's "
                             f"{want_norms}: {rel_n} (tol {TP_NORM_TOL})")
    # per step: 2 rows x 2 microbatches x 2 shards x the layers, each
    # forward and its checkpoint's recomputation
    per_step = 2 * 2 * 2 * TP_LAYERS * 2
    if counts["flash_attention_fwd"] != per_step * MESH_STEPS:
        raise AssertionError(f"flash launched {counts['flash_attention_fwd']}"
                             f" times on the TP ring; expected {per_step} "
                             f"per step")
    oracle = _tp_reduced_oracle(torch)
    one, r = float(np.median(ms1)), float(np.median(ms))
    print(f"  {cfg.name} ({TP_LAYERS} of {get_config(TP_ARCH).n_layers} "
          f"layers, full width) TP + SP "
          f"grain, (2, 2) ring of this card, global batch {MESH_BATCH} x "
          f"{MESH_SEQ}: losses {got} against one device's {want} (relative "
          f"{max(rel):.2e}, tol {TP_LOSS_TOL}); gradient norms {got_norms} "
          f"against {want_norms} (relative {max(rel_n):.2e}, tol "
          f"{TP_NORM_TOL}); step {r:.1f} ms against one "
          f"device's {one:.1f} ms; peak memory {peak / 1e9:.2f} GB; "
          f"collective bytes per step {coll}; flash launched "
          f"{counts['flash_attention_fwd']} times at the shard shape; "
          f"reduced f32 copy: gradients within {oracle:.2e} of max |g| of "
          f"one device's, the update within {LM_GRAD_TOL}")
    return {"ms": r, "one_ms": one, "peak": peak, "coll": coll,
            "launches": counts["flash_attention_fwd"]}


def _chain(torch, step_pf, step_dc, model, batch, feed, max_len: int):
    """A prefill of ``batch`` (cache capacity ``max_len``), then
    ``MESH_NEW`` decode steps, step t fed ``feed(t, logits)``: (the
    last-position logits after each step, ms of the prefill, ms per decode
    step, collective bytes of the prefill and per decode step)."""
    from repro_torch.parallel import sharding as SH
    torch.cuda.synchronize()
    c0 = SH.collective_bytes()
    t0 = time.perf_counter()
    logits, cache = step_pf(model, batch, max_len=max_len)
    out = [logits]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    c1 = SH.collective_bytes()
    s = next(iter(batch.values())).shape[1]
    for t in range(MESH_NEW):
        pos = torch.full((logits.shape[0],), s + t, device="cuda")
        logits, cache = step_dc(model, cache, dict(feed(t, logits),
                                                   position=pos))
        out.append(logits)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    c2 = SH.collective_bytes()
    return out, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / MESH_NEW, \
        {k: c1[k] - c0[k] for k in c0}, \
        {k: (c2[k] - c1[k]) // MESH_NEW for k in c0}


def mesh_serve(torch, cfg, tol, label) -> dict:
    """``build_prefill_step``/``build_decode_step`` on a (1, 2) ring
    (head-sharded cache) and a (1, 4) ring (sequence-sharded) of this
    card against one device: a 2 x ``MESH_PROMPT`` prefill and
    ``MESH_NEW`` greedy steps (the rings fed the one-device run's
    tokens), each step's logits within ``tol`` of max |logit|."""
    from repro_torch.launch.mesh import make_host_mesh, make_mesh_for
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import ring
    from repro_torch.train import step as S

    gen = torch.Generator().manual_seed(22)
    model = init_params(cfg, seed=0)
    prompt = torch.randint(0, cfg.vocab, (2, MESH_PROMPT),
                           generator=gen).cuda()
    host = make_host_mesh()
    fed = []

    def greedy(t, logits):
        fed.append(logits.argmax(-1)[:, None])
        return {"tokens": fed[-1]}

    max_len = prompt.shape[1] + MESH_NEW
    want, pf_ms, dc_ms, _, _ = _chain(
        torch, S.build_prefill_step(host), S.build_decode_step(host), model,
        {"tokens": prompt}, greedy, max_len)
    out = {"one": (pf_ms, dc_ms)}
    for shape in ((1, 2), (1, 4)):
        mesh = make_mesh_for(*shape, devices=_ring_devices(torch, shape[1]))
        mp = ring.shard_params(model, mesh, tp=True)
        _reset_lm_counts()
        got, r_pf, r_dc, _, _ = _chain(
            torch, S.build_prefill_step(mesh), S.build_decode_step(mesh), mp,
            {"tokens": prompt}, lambda t, _: {"tokens": fed[t]}, max_len)
        counts = _lm_counts()
        errs = [((g - w).abs().max() / w.abs().max()).item()
                for g, w in zip(got, want)]
        if not max(errs) <= tol or not counts["flash_attention_fwd"]:
            raise AssertionError(f"{label} on a {shape} ring: logits off "
                                 f"one device's by {errs} of max |logit| "
                                 f"(tol {tol}); flash launches {counts}")
        grain = ring.cache_grain(cfg, mesh)
        print(f"  {label} served on a {shape} ring ({grain}-sharded "
              f"cache): prefill 2 x {MESH_PROMPT} and {MESH_NEW} decode "
              f"steps within {max(errs):.2e} of max |logit| of one device's "
              f"(tol {tol}); prefill {r_pf:.1f} ms, decode {r_dc:.2f} ms per "
              f"step against one device's {pf_ms:.1f} ms and {dc_ms:.2f} ms; "
              f"flash launched {counts['flash_attention_fwd']} times")
        out[shape] = (r_pf, r_dc)
        del mp
    del model
    torch.cuda.empty_cache()
    return out


def mesh_elastic(torch, tmp) -> None:
    """qwen2.5-3b at full width, its depth cut to ``ELASTIC_LAYERS`` and
    its sequence to ``ELASTIC_SEQ``, DP grain: a (2, 2) ring run saved
    after step 1, restored onto (4, 1) (every gathered leaf bitwise the
    saved one) for step 2, saved again and restored onto (1, 1) for step
    3 in 4 microbatches: both steps' losses and the final parameters
    bitwise the uninterrupted run's."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh, make_mesh_for
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import ring
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import ft
    from repro_torch.train import optimizer as O
    from repro_torch.train import step as S

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(DENSE_ARCH), n_layers=ELASTIC_LAYERS)
    dev = _ring_devices(torch, MESH_RING)
    m22, m41 = make_mesh_for(2, 2, devices=dev), make_mesh_for(4, 1,
                                                               devices=dev)
    m11 = make_host_mesh()
    opt_cfg = O.AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=1, total_steps=100)
    data = SyntheticLM(cfg.vocab, MESH_BATCH, ELASTIC_SEQ, seed=4)
    batches = [S.to_device(data.batch_at(i), "cuda") for i in range(3)]

    def run(mesh, state, idx, n_mb=1):
        step, _ = S.build_train_step(cfg, mesh, opt_cfg,
                                     S.StepPlan(n_microbatches=n_mb,
                                                tp=False))
        return [float(step(state, batches[i])[1]["loss"]) for i in idx]

    model = init_params(cfg, seed=0, trainable=True)
    a = ring.init_state(model, m22, tp=False)
    del model
    want = run(m22, a, [0])
    d = os.path.join(tmp, "elastic")
    ckpt.save(d, 1, a, extra={"next_step": 1})
    b = ft.elastic_restore(d, 1, a, m41)
    ga, gb = a.global_state("cuda"), b.global_state("cuda")
    pairs = [(ga.params, gb.params), (ga.opt.m, gb.opt.m),
             (ga.opt.v, gb.opt.v)]
    bad = [n for x, y in pairs for n in x if not torch.equal(x[n](), y[n]())]
    del ga, gb, pairs
    want += run(m22, a, [1, 2])          # the uninterrupted run
    got = run(m41, b, [1])
    ckpt.save(d, 2, b, extra={"next_step": 2})
    c = ft.elastic_restore(d, 2, b, m11)
    del b
    got += run(m11, c, [2], n_mb=MESH_BATCH)
    ga, gc = a.global_state("cuda"), c.global_state("cuda")
    bad += [n for n in ga.params if not torch.equal(ga.params[n](),
                                                    gc.params[n]())]
    if bad or got != want[1:]:
        raise AssertionError(f"elastic restore: leaves {bad[:6]} differ; "
                             f"losses {got} against {want[1:]}")
    del a, c, ga, gc
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"  elastic restore ({cfg.name}, {ELASTIC_LAYERS} of "
          f"{get_config(DENSE_ARCH).n_layers} layers, full width, global "
          f"batch {MESH_BATCH} x {ELASTIC_SEQ}): saved after step 1 on "
          f"(2, 2), restored onto (4, 1) with every leaf bitwise the saved "
          f"one, step 2 there, saved, restored onto (1, 1), step 3 in "
          f"{MESH_BATCH} microbatches: losses {got} bitwise the "
          f"uninterrupted run's, its parameters too; "
          f"{time.perf_counter() - t0:.1f} s")


def flash_shard_row(torch, shape, launches: int, row_name: str,
                    what: str, seed: int) -> dict:
    """The flash kernel at a ring shard's shape ``shape`` = (b, s, s, h,
    hkv, d), causal: held against its plain version in f32 and bf16, then
    the row ``row_name`` (bf16 kernel, plain version,
    ``scaled_dot_product_attention``, bound), its launches the ring's."""
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    from repro_torch.kernels.meta import flash_flops

    F = torch.nn.functional
    b, s, _, h, hkv, d = shape
    gen = torch.Generator().manual_seed(seed)
    errs = {}
    for dtype in ("float32", "bfloat16"):
        q, kk, v = (torch.randn((b * n, s, d), generator=gen)
                    .to("cuda", getattr(torch, dtype)) for n in (h, hkv, hkv))
        _hold(torch, "flash_attention_fwd", dtype,
              flash_attention_fwd(q, kk, v, causal=True),
              flash_attention_plain(q, kk, v, causal=True), errs,
              f"q {tuple(q.shape)} k {tuple(kk.shape)} ({what})",
              key=row_name)
    q4, k4, v4 = (t.view(b, -1, s, d) for t in (q, kk, v))
    k4, v4 = (t.repeat_interleave(h // hkv, 1) for t in (k4, v4))
    return kernel_row(
        torch, {}, errs, "flash_attention_fwd",
        lambda: flash_attention_fwd(q, kk, v, causal=True),
        lambda: flash_attention_plain(q, kk, v, causal=True),
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        lambda o: o.reshape(b * h, s, d), flash_flops(b * h, s, s, d, True),
        (q.numel() + kk.numel() + v.numel()) * 2,
        f"q ({b * h}, {s}, {d}) bf16 causal, {h} heads over {hkv} kv heads "
        f"({what})", row_name=row_name, err_key=row_name, launches=launches)


def lm_mesh_phase(torch, np, tmp) -> dict:
    """Phase 19: the LM path on rings of this card (``parallel/ring.py``):
    the DP grain bitwise, the TP + SP grain, serving in both cache grains,
    elastic restore, and the flash kernel's row at the TP shard shape.
    Returns the rings' measurements (for the dry run's model in phase 20)
    and the row."""
    from repro_torch.configs.registry import get_config, reduced

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"LM mesh phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated before it; rings of {MESH_RING} x this card (no speed "
          f"is claimed: the shards share one card)")
    dp = mesh_dp(torch, np)
    tp = mesh_tp(torch, np)
    mesh_serve(torch, get_config(DENSE_ARCH), ORACLE_TOL, DENSE_ARCH)
    mesh_serve(torch, reduced(get_config(DENSE_ARCH)), 1e-4,
               f"reduced {DENSE_ARCH} (f32)")
    mesh_elastic(torch, tmp)
    row = flash_shard_row(torch, TP_FLASH, tp["launches"],
                          "flash_attention_fwd_tp_shard",
                          f"{TP_ARCH}'s TP shard at m = 2", 23)
    print(f"LM mesh phase: {time.perf_counter() - t0:.1f} s")
    return {"dp": dp, "tp": tp, "row": row}


# --------------------------------------------------------------------------
# The attention-block families on a mesh: moe, vlm and audio on rings of
# this card
# --------------------------------------------------------------------------
MOE_RINGS = ((1, 8), (1, 16))   # grok: one expert per shard, then TP inside
MESH_TOL = 2e-2                 # of max |logit|, bf16 serving rings
# a ring's bf16 roundings may flip an expert pick where one device's top
# two router probabilities lie this close: that step's logits are then
# another computation, and the chain is compared up to it
FLIP_MARGIN = 2e-2
# the (1, 16) ring's sequence-sharded cache needs a multiple of 16
MESH_MAX_LEN = -(-(MESH_PROMPT + MESH_NEW) // 16) * 16
AUDIO_RING = (1, 4)
VLM_ARCH = "llava-next-mistral-7b"
VLM_LAYERS = 8             # llava's 32 layers cut to 8: see attn_mesh_train
ROUTED_ARCHS = ("grok-1-314b", "arctic-480b")
ROUTED_CF = 1.25           # the full configs' capacity factor: tokens drop
ROUTED_TOL = 1e-4
# the flash kernel at a (1, 16) shard of grok-1-314b's prefill: 48 / 16 q
# heads reading one k/v head, 2 x 2048, D = 128 (bf16, causal)
MOE_FLASH = (2, MESH_PROMPT, MESH_PROMPT, 3, 1, 128)


def _mesh_model_bytes(cfg, shape, kind: str, bsz: int, seq: int,
                      n_mb: int = 1, tp=None) -> dict:
    """The dry run's model (one representative position of a ``meta``
    ring of ``shape``, its counts times the chips) of one step: its
    collective bytes by kind (a train step in the grain ``tp``, default
    ``default_plan``'s)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_for
    cell = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k", "long": "long_500k"}[kind]
    meta = make_mesh_for(*shape, devices=("meta",) * (shape[0] * shape[1]))
    r = dryrun.run_config(cfg, cell, mesh=meta, batch_override=bsz,
                          seq_override=seq, n_microbatches=n_mb, tp=tp)
    if r["status"] != "ok" or r["source"] != "model":
        raise AssertionError(f"{cfg.name} {cell} on {shape}: {r}")
    return {k.replace("-", "_"): v
            for k, v in r["collectives"]["ring_bytes"].items()}


def _one_prefill(torch, capacity_factor):
    """The one-device prefill step at ``capacity_factor`` (drop-free for
    MoE, as the rings serve), its cache padded to ``max_len``."""
    F = torch.nn.functional

    kw = {} if capacity_factor is None else {
        "capacity_factor": capacity_factor}

    @torch.no_grad()
    def prefill(model, batch, max_len):
        logits, cache = model.prefill(tokens=batch.get("tokens"),
                                      embeds=batch.get("embeds"), **kw)
        if "kv" in cache:
            pad = max_len - cache["kv"]["k"].shape[2]
            cache["kv"] = {k: F.pad(t, (0, 0, 0, 0, 0, pad))
                           for k, t in cache["kv"].items()}
        return logits[:, -1], cache
    return prefill


def _ring_kernels(cfg) -> tuple:
    """The kernels a family's ring path launches: flash in every
    attention block, causal_conv1d in every Mamba2 layer; rwkv6 none."""
    return {"hybrid": ("causal_conv1d", "flash_attention_fwd"),
            "ssm": ()}.get(cfg.family, ("flash_attention_fwd",))


class _RouteLog:
    """Records every ``models.moe.route_topk`` call inside the ``with``
    block: (the picks (T, k), the gap between the k-th and the next
    router probability per token), on the host."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.real = moe, moe.route_topk

        def logged(logits, top_k):
            gates, idx = self.real(logits, top_k)
            p = self.torch.softmax(logits.float(), -1).sort(
                -1, descending=True).values
            self.calls.append((idx.cpu(), (p[:, top_k - 1] - p[:, top_k])
                               .cpu()))
            return gates, idx
        moe.route_topk = logged
        return self

    def __exit__(self, *exc):
        self.moe.route_topk = self.real


def _first_flip(one: _RouteLog, ring: _RouteLog, n_layers: int, m: int,
                bsz: int, s: int):
    """(the first chain step whose last-position picks differ between one
    device and a ring of ``m`` model shards (0: the prefill), the smallest
    one-device margin among the differing tokens), or None: a ring's
    shard 0 routes the same tokens in the same order as one device."""
    for step in range(1 + MESH_NEW):
        for li in range(n_layers):
            a_idx, a_gap = one.calls[step * n_layers + li]
            b_idx, _ = ring.calls[(step * n_layers + li) * m]
            rows = [b * s + s - 1 for b in range(bsz)] if step == 0 \
                else list(range(bsz))
            bad = [r for r in rows if not bool((a_idx[r] == b_idx[r]).all())]
            if bad:
                return step, min(float(a_gap[r]) for r in bad)
    return None


def ring_serve(torch, cfg, rings, batch, steps_in, label,
               tol=MESH_TOL) -> dict:
    """``cfg`` served on each ring of ``rings`` against one device: a
    prefill of ``batch`` and ``MESH_NEW`` decode steps (``steps_in``: the
    inputs of each step, or None for greedy tokens, the rings fed the
    one-device run's), each step's logits within ``tol`` of max |logit|
    (None: the gap printed, not held);
    the ``repro.mesh.*`` bytes of the prefill and of a decode step equal
    to the dry run's model; each kernel of the family's path launched.
    Returns each ring's times and launches by kernel."""
    from repro_torch.launch.mesh import make_host_mesh, make_mesh_for
    from repro_torch.models.moe import drop_free_factor
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import ring
    from repro_torch.train import step as S

    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)
    free = None if cfg.moe is None else drop_free_factor(cfg.moe)
    fed = []

    def greedy(t, logits):
        fed.append(logits.argmax(-1)[:, None])
        return {"tokens": fed[-1]}

    host = make_host_mesh()
    for _ in range(2):          # the first a warm-up: its prefill is cold
        fed.clear()
        with _RouteLog(torch) as one_log:
            want, pf1, dc1, _, _ = _chain(
                torch, _one_prefill(torch, free), S.build_decode_step(host),
                model, batch, steps_in or greedy, MESH_MAX_LEN)
    forced = steps_in or (lambda t, _: {"tokens": fed[t]})
    out = {"one": (pf1, dc1), "launches": {}}
    bsz, s = next(iter(batch.values())).shape[:2]
    for shape in rings:
        n = shape[0] * shape[1]
        mesh = make_mesh_for(*shape, devices=_ring_devices(torch, n))
        mp = ring.shard_params(model, mesh, tp=True)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _reset_lm_counts()
        with _RouteLog(torch) as ring_log:
            got, r_pf, r_dc, c_pf, c_dc = _chain(
                torch, S.build_prefill_step(mesh), S.build_decode_step(mesh),
                mp, batch, forced, MESH_MAX_LEN)
        launches = {k: v for k, v in _lm_counts().items()
                    if k in _ring_kernels(cfg)}
        peak = torch.cuda.max_memory_allocated() - base
        errs = [((g - w).abs().max() / w.abs().max()).item()
                for g, w in zip(got, want)]
        flip = None if cfg.moe is None else _first_flip(
            one_log, ring_log, cfg.n_layers, shape[1], bsz, s)
        held = errs if flip is None else errs[:flip[0]]
        if flip is not None and not (flip[0] > 0
                                     and flip[1] <= FLIP_MARGIN):
            raise AssertionError(f"{label} on a {shape} ring: an expert "
                                 f"pick differs from one device's at step "
                                 f"{flip[0]}, router margin {flip[1]:.3e} "
                                 f"(a near-tie is at most {FLIP_MARGIN})")
        if not (tol is None or max(held) <= tol) or \
                not all(launches.values()):
            raise AssertionError(f"{label} on a {shape} ring: logits off "
                                 f"one device's by {errs} of max |logit| "
                                 f"(tol {tol}); launches {launches}")
        flipped = "" if flip is None else (
            f", then at step {flip[0]} an expert pick flipped at a "
            f"near-tie (one device's router margin {flip[1]:.2e}; that "
            f"step's error {errs[flip[0]]:.2e} and later ones not held)")
        m_pf = _mesh_model_bytes(cfg, shape, "prefill", bsz, s)
        m_dc = _mesh_model_bytes(cfg, shape, "decode", bsz, MESH_MAX_LEN)
        if m_pf != c_pf or m_dc != c_dc:
            raise AssertionError(f"{label} on {shape}: the dry run's model "
                                 f"{m_pf} / {m_dc} != the ring's counters "
                                 f"{c_pf} / {c_dc}")
        grain = ring.cache_grain(cfg, mesh)
        grain = "no k/v, the state by head" if grain is None \
            else f"{grain}-sharded cache"
        moe = "" if cfg.moe is None else (
            "expert parallelism, " if cfg.moe.n_experts >= shape[1]
            else "TP inside the experts, ")
        print(f"  {label} served on a {shape} ring ({moe}{grain}): "
              f"prefill {bsz} x {s} and {len(held) - 1} of "
              f"{MESH_NEW} decode steps within {max(held):.2e} of max "
              f"|logit| of one device's (by step "
              f"{[f'{e:.2e}' for e in errs]}) "
              f"({'not held' if tol is None else f'tol {tol}'}){flipped}; "
              f"prefill {r_pf:.1f} ms, decode {r_dc:.2f} ms "
              f"per step against one device's {pf1:.1f} ms and {dc1:.2f} "
              f"ms; peak {peak / 1e9:.2f} GB above the shards; collective "
              f"bytes of the prefill {c_pf} and per decode step {c_dc}, "
              f"equal to the dry run's model; launches {launches}")
        out[shape] = (r_pf, r_dc, peak)
        out["launches"][shape] = launches
        del mp
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    print(f"  {label}: {time.perf_counter() - t0:.1f} s")
    return out


def attn_mesh_train(torch, np) -> dict:
    """llava-next-mistral-7b at full width, its depth cut to
    ``VLM_LAYERS`` (a one-device train state is 14 bytes per parameter:
    with a step's transients half the model, 16 layers, would leave no
    room for the earlier phases' leftovers), in the TP + SP grain
    (``default_plan``'s at d_model 4096) on a (2, 2) ring of this card:
    ``ring_train`` at global batch 4 x 4096 of seeded bf16 embeddings (2
    per data row in 2 microbatches of 1)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.train import step as S

    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    mesh = make_mesh_for(2, 2, devices=_ring_devices(torch, MESH_RING))
    plan = dataclasses.replace(S.default_plan(cfg, "train_4k", mesh),
                               n_microbatches=2)
    if not (plan.tp and plan.seq_shard_activations):
        raise AssertionError(f"{cfg.name}: default_plan did not pick TP + SP")
    gen = torch.Generator(device="cuda").manual_seed(24)
    batches = [{"embeds": torch.randn((MESH_BATCH, MESH_SEQ, cfg.d_model),
                                      generator=gen, device="cuda")
                .to(torch.bfloat16),
                "labels": torch.randint(0, cfg.vocab, (MESH_BATCH, MESH_SEQ),
                                        generator=gen, device="cuda")}
               for _ in range(MESH_STEPS)]
    return ring_train(torch, np, cfg, mesh, plan, batches,
                      f"{cfg.name} ({VLM_LAYERS} of "
                      f"{get_config(VLM_ARCH).n_layers} layers, full width, "
                      f"bf16 embeds)")


def ring_train(torch, np, cfg, mesh, plan, batches, label,
               held_steps=None) -> dict:
    """``cfg`` trained in ``plan``'s TP + SP grain on ``mesh``, a ring of
    this card, against one device, from the same seeded weights: one step
    per batch of ``batches`` (``plan.n_microbatches`` per data row; one
    device runs a microbatch per row), the first ``held_steps`` (default
    all) steps' losses within ``TP_LOSS_TOL`` and gradient norms within
    ``TP_NORM_TOL`` relative, later ones printed; the collective bytes
    per step equal to the dry run's model; each kernel of the family's
    path launched as often as its layers, rows, microbatches and shards
    and the checkpoint's recomputation make it, and causal_conv1d's
    backward kernels once per ``CausalConv1d`` backward.  One device runs
    first and is freed before the ring's state is laid out."""
    from repro_torch.kernels.causal_conv1d import CausalConv1d
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import ctx, ring
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import optimizer as O
    from repro_torch.train import step as S

    t0 = time.perf_counter()
    opt_cfg = O.AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=1, total_steps=100)
    bsz, seq = batches[0]["labels"].shape
    base = torch.cuda.memory_allocated()
    model = init_params(cfg, seed=0, trainable=True)
    state = S.init_train_state(model)
    step1, _ = S.build_train_step(cfg, make_host_mesh(), opt_cfg,
                                  S.StepPlan(n_microbatches=bsz), model)
    torch.cuda.reset_peak_memory_stats()
    want, ms1, want_norms = _timed_steps(torch, step1, state, batches)
    peak1 = torch.cuda.max_memory_allocated() - base
    del model, state, step1
    torch.cuda.empty_cache()
    model = init_params(cfg, seed=0, trainable=True)
    rstate = ring.init_state(model, mesh, tp=True)
    del model
    torch.cuda.empty_cache()
    step, hooks = S.build_train_step(cfg, mesh, opt_cfg, plan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_lm_counts()
    f0 = _flash_bwd_calls()
    c0 = CausalConv1d.backward_calls
    coll0 = SH.collective_bytes()
    with ctx.activation_sharding(hooks):
        got, ms, got_norms = _timed_steps(torch, step, rstate, batches)
    if "flash_attention_fwd" in _ring_kernels(cfg):
        _held_flash_bwd(f"{cfg.name} ring", _lm_counts(),
                        _flash_bwd_calls() - f0)
    conv_bwd = CausalConv1d.backward_calls - c0
    if "causal_conv1d" in _ring_kernels(cfg) and not (
            conv_bwd and _lm_counts()["causal_conv1d_bwd"] == conv_bwd):
        raise AssertionError(f"{cfg.name} ring: CausalConv1d's backward ran "
                             f"{conv_bwd} times and launched its kernels "
                             f"{_lm_counts()['causal_conv1d_bwd']} times")
    launches = {k: v for k, v in _lm_counts().items()
                if k in _ring_kernels(cfg)}
    coll = {k: v // len(batches) for k, v in _coll_delta(coll0).items()}
    peak = torch.cuda.max_memory_allocated() - base
    split = ring.replica_mismatches(rstate)
    del rstate
    torch.cuda.empty_cache()
    if split:
        raise AssertionError(f"replicated leaves' copies differ on the "
                             f"{cfg.name} TP ring: {split[:6]}")
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    rel_n = [abs(g - w) / abs(w) for g, w in zip(got_norms, want_norms)]
    held = held_steps or len(batches)
    if not (max(rel[:held]) <= TP_LOSS_TOL
            and max(rel_n[:held]) <= TP_NORM_TOL):
        raise AssertionError(f"{cfg.name} TP ring losses {got} / norms "
                             f"{got_norms} against one device's {want} / "
                             f"{want_norms}: {rel} / {rel_n}")
    # forward and checkpoint recomputation, per unit, data row,
    # microbatch and model shard
    per_unit = 2 * mesh.shape["data"] * plan.n_microbatches * \
        mesh.shape["model"]
    kinds = [kind for kind, _, _ in ring._units(cfg)]
    expect = {"flash_attention_fwd": kinds.count("attn") * per_unit,
              "causal_conv1d": kinds.count("mamba") * per_unit}
    expect = {k: expect[k] * len(batches) for k in launches}
    if launches != expect:
        raise AssertionError(f"{cfg.name} ring launches {launches}; "
                             f"expected {expect}")
    model_coll = _mesh_model_bytes(cfg, mesh.devices.shape, "train", bsz,
                                   seq, plan.n_microbatches, tp=True)
    if model_coll != coll:
        raise AssertionError(f"{cfg.name}: the dry run's collective model "
                             f"{model_coll} != the ring's counters {coll}")
    one, r = float(np.median(ms1)), float(np.median(ms))
    print(f"  {label} TP + SP grain, {tuple(mesh.devices.shape)} ring of "
          f"this card, global batch {bsz} x {seq}: losses {got} against one "
          f"device's {want} (relative {[f'{x:.2e}' for x in rel]}, the "
          f"first {held} held at {TP_LOSS_TOL}); gradient norms "
          f"{got_norms} against {want_norms} (relative "
          f"{[f'{x:.2e}' for x in rel_n]}, held at {TP_NORM_TOL}); step "
          f"{r:.1f} ms "
          f"({[round(x, 1) for x in ms]}) against one device's {one:.1f} ms "
          f"({[round(x, 1) for x in ms1]}); peak memory {peak / 1e9:.2f} GB "
          f"(one device {peak1 / 1e9:.2f} GB); collective bytes per step "
          f"{coll}, equal to the dry run's model; launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s")
    return {"ms": r, "one_ms": one, "peak": peak, "coll": coll,
            "launches": launches}


def attn_mesh_routed(torch) -> None:
    """Reduced grok-1-314b and arctic-480b (f32) at capacity factor
    ``ROUTED_CF``, where tokens drop: the DP grain on a (2, 2) ring and
    expert parallelism on a (1, 2) ring, each microbatch routed as one
    set, against the one-device step with the same microbatches (the
    reference's routing set): the loss, ``moe_aux`` and every gradient
    within ``ROUTED_TOL`` (relative, and of max |g| per leaf); the DP
    ring's collective bytes per step (the routing exchange among them)
    equal to the dry run's model."""
    import dataclasses
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.launch.mesh import make_host_mesh, make_mesh_for
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import ctx, ring
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import optimizer as O
    from repro_torch.train import step as S

    t0 = time.perf_counter()
    opt_cfg = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    gen = torch.Generator().manual_seed(25)
    for arch in ROUTED_ARCHS:
        cfg = reduced(get_config(arch))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=ROUTED_CF))
        model = init_params(cfg, seed=5, trainable=True)
        batch = {k: torch.randint(0, cfg.vocab, (4, 64), generator=gen)
                 .cuda() for k in ("tokens", "labels")}
        ostep, _ = S.build_train_step(
            cfg, make_host_mesh(), opt_cfg,
            S.StepPlan(n_microbatches=1, skip_update=True), model)
        _, om = ostep(S.init_train_state(model), batch)
        drops = []
        for shape, tp in (((2, 2), False), ((1, 2), True)):
            mesh = make_mesh_for(*shape, devices=_ring_devices(
                torch, shape[0] * shape[1]))
            plan = S.StepPlan(n_microbatches=1, tp=tp)
            rstate = ring.init_state(model, mesh, tp=tp)
            gstep, hooks = S.build_train_step(
                cfg, mesh, opt_cfg, dataclasses.replace(plan,
                                                        skip_update=True))
            with ctx.activation_sharding(hooks):
                _, gm = gstep(rstate, batch)
            got = ring.gather_grads(rstate.params, gm["grads"], "cuda")
            err_l = abs(float(gm["loss"]) - float(om["loss"])) / \
                abs(float(om["loss"]))
            err_g = max(((got[n] - g).abs().max() / g.abs().max()).item()
                        for n, g in om["grads"].items())
            if not (err_l <= ROUTED_TOL and err_g <= ROUTED_TOL):
                raise AssertionError(f"{cfg.name} on {shape}: loss off by "
                                     f"{err_l:.2e}, gradients by {err_g:.2e}"
                                     f" (tol {ROUTED_TOL})")
            step, hooks = S.build_train_step(cfg, mesh, opt_cfg, plan)
            coll0 = SH.collective_bytes()
            with ctx.activation_sharding(hooks):
                _, m = step(rstate, batch)
            coll = _coll_delta(coll0)
            if not tp:
                model_coll = _mesh_model_bytes(cfg, shape, "train", 4, 64)
                if model_coll != coll:
                    raise AssertionError(f"{cfg.name} DP ring: the dry "
                                         f"run's model {model_coll} != "
                                         f"the counters {coll}")
            drops.append(f"{shape} {'EP' if tp else 'DP'}: loss "
                         f"{float(gm['loss']):.6f} against "
                         f"{float(om['loss']):.6f} (relative {err_l:.1e}),"
                         f" gradients within {err_g:.1e} of max |g|, "
                         f"moe_aux {float(m['moe_aux']):.6f}, collective "
                         f"bytes {coll}")
            del rstate
        print(f"  reduced {arch} (f32, capacity factor {ROUTED_CF}), each "
              f"microbatch routed as one set: " + "; ".join(drops))
        del model
    torch.cuda.empty_cache()
    print(f"  routed MoE rings: {time.perf_counter() - t0:.1f} s")


def attn_mesh_phase(torch, np) -> dict:
    """Phase 19b: the moe, vlm and audio families on rings of this card:
    grok-1-314b at full width (depth cut to ``MOE_LAYERS``) served on
    (1, 8) and (1, 16), musicgen-large uncut served on (1, 4),
    llava-next-mistral-7b trained in the TP + SP grain on (2, 2), the
    reduced MoE routing sets, and the flash kernel's row at the (1, 16)
    grok shard's shape.  Returns the row."""
    import dataclasses
    from repro_torch.configs.registry import get_config

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"attention families on a mesh: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before "
          f"it; rings of this card (no speed is claimed: the shards share "
          f"one card)")
    gen = torch.Generator().manual_seed(27)
    grok = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    prompt = torch.randint(0, grok.vocab, (2, MESH_PROMPT),
                           generator=gen).cuda()
    served = ring_serve(torch, grok, MOE_RINGS, {"tokens": prompt},
                        None, f"{MOE_ARCH} ({MOE_LAYERS} of "
                        f"{get_config(MOE_ARCH).n_layers} layers)")
    audio = get_config(AUDIO_ARCH)
    emb = torch.randn((2, MESH_PROMPT + MESH_NEW, audio.d_model),
                      generator=gen).to("cuda", torch.bfloat16)
    ring_serve(torch, audio, (AUDIO_RING,),
               {"embeds": emb[:, :MESH_PROMPT]},
               lambda t, _: {"embeds": emb[:, MESH_PROMPT + t:][:, :1]},
               f"{AUDIO_ARCH} (uncut, bf16 embeds)")
    attn_mesh_train(torch, np)
    attn_mesh_routed(torch)
    row = flash_shard_row(torch, MOE_FLASH,
                          served["launches"][MOE_RINGS[-1]][
                              "flash_attention_fwd"],
                          "flash_attention_fwd_moe_shard",
                          f"{MOE_ARCH}'s (1, 16) shard prefill", 26)
    print(f"attention families on a mesh: {time.perf_counter() - t0:.1f} s")
    return row


# --------------------------------------------------------------------------
# The recurrent families on a mesh: zamba2-7b (Mamba2 layers and a shared
# attention block) and rwkv6-3b on rings of this card
# --------------------------------------------------------------------------
HYBRID_RING = (1, 4)       # zamba2-7b uncut: 28 Mamba2, 8 q and 8 k/v heads
HYBRID_CUT = 15            # 2 groups of 6 + 3 tail layers (of 81)
HYBRID_CUT_RING = (1, 16)  # 7 Mamba2 heads a shard, 2 k/v heads
SSM_RING = (1, 4)          # rwkv6-3b uncut: 10 heads a shard
SSM_UNEVEN_RING = (1, 16)  # 40 heads over 16: 3 or 2 a shard, the
SSM_UNEVEN_LAYERS = 8      # projections gathered whole (host-bound: 32
#                            layers took 46 s of a budget of 150)
LONG_RING = (4, 4)         # long_500k: batch 1 on every data row
LONG_LEN = 524288          # its cache, 131 072 positions a data row
LONG_STEPS = 4             # zamba2's; rwkv6's decode 2 (its state is the
SSM_LONG_STEPS = 2         # same size at any position)
SSM_TRAIN_LAYERS = 8       # rwkv6-3b's 32 layers cut to 8 for training
RECURRENT_BATCH = 2        # the train runs' global batch (train_4k's 256)
# flash at zamba2-7b's (1, 4) head shard: 32 / 4 q heads over as many k/v
# heads, 2 x 2048, D = 112 (bf16, causal)
HYBRID_FLASH = (2, MESH_PROMPT, MESH_PROMPT, 8, 8, 112)


def conv_shard_row(torch, m: int, launches: int, seed: int) -> dict:
    """causal_conv1d at zamba2-7b's Mamba2 shard of ``m`` model shards,
    x [2, 2048, 7168 / m + 128], K = 4: held against its plain version in
    f32 and bf16, then its row (bf16 kernel, plain version, depthwise
    ``F.conv1d``, bound), its launches the ring's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.causal_conv1d import (causal_conv1d,
                                                   causal_conv1d_plain)
    from repro_torch.kernels.meta import causal_conv1d_flops

    F = torch.nn.functional
    ssm = get_config(LM_ARCH).ssm
    c = ssm.expand * get_config(LM_ARCH).d_model // m \
        + 2 * ssm.n_groups * ssm.state
    b, l, k = PREFILL_B, MESH_PROMPT, ssm.conv_kernel
    name = f"causal_conv1d_mamba_shard_{m}"
    gen = torch.Generator().manual_seed(seed)
    errs = {}
    for dtype in ("float32", "bfloat16"):
        x = torch.randn((b, l, c), generator=gen).to("cuda",
                                                    getattr(torch, dtype))
        w = (torch.randn((k, c), generator=gen) * 0.2).to(x)
        _hold(torch, "causal_conv1d", dtype, causal_conv1d(x, w),
              causal_conv1d_plain(x, w), errs, f"x {(b, l, c)} K={k}",
              key=name)
    xt, wt = x.transpose(1, 2).contiguous(), w.t().contiguous()[:, None, :]
    return kernel_row(
        torch, {}, errs, "causal_conv1d", lambda: causal_conv1d(x, w),
        lambda: causal_conv1d_plain(x, w),
        lambda: F.conv1d(xt, wt, padding=k - 1, groups=c)[..., :l],
        lambda y: y.transpose(1, 2), causal_conv1d_flops(b, l, c, k),
        (x.numel() + w.numel()) * 2,
        f"x [{b}, {l}, {c}] bf16, K={k} ({LM_ARCH}'s Mamba2 shard at "
        f"m = {m})", row_name=name, err_key=name, launches=launches)


def long_decode(torch, cfg, label, tol=MESH_TOL, steps=LONG_STEPS) -> dict:
    """``long_500k``'s grain: ``cfg`` on a ``LONG_RING`` ring of this
    card, its batch of 1 on every data row, against one device on the
    same seeded cache of ``LONG_LEN`` positions (the k/v's sequence over
    "data", its heads over "model"; the recurrent states replicated over
    the data rows): ``steps`` decode steps at the cache's last
    positions, each step's logits within ``tol`` of max |logit|; the
    first step's collective bytes equal to the dry run's model; at the
    last step every data row's logits equal."""
    from repro_torch.launch.mesh import make_host_mesh, make_mesh_for
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import ctx, ring
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import step as S

    t0 = time.perf_counter()
    n = LONG_RING[0] * LONG_RING[1]
    mesh = make_mesh_for(*LONG_RING, devices=_ring_devices(torch, n))
    model = init_params(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(29)
    tree = model.init_cache(1, LONG_LEN)
    for _, leaf in SH._flat_items(tree):
        leaf.normal_(generator=gen)
    mp = ring.shard_params(model, mesh, tp=True)
    cache = ring.shard_cache(mp, tree)
    if cache.split or (cfg.family == "hybrid"
                       and cache.seq_axes != ("data",)):
        raise AssertionError(f"{label}: the long_500k cache is laid out "
                             f"{cache.spec} (split {cache.split})")
    held = sum(t.numel() * t.element_size() for sh in cache.shards
               for t in sh.values())
    toks = torch.randint(0, cfg.vocab, (steps, 1, 1), generator=gen,
                         device="cuda")
    one, ring_dc = S.build_decode_step(make_host_mesh()), \
        S.build_decode_step(mesh)
    errs, ms, ms1, coll = [], [], [], None
    for t in range(steps):
        batch = {"tokens": toks[t],
                 "position": torch.full((1,), LONG_LEN - steps + t,
                                        device="cuda")}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want, _ = one(model, tree, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        c0 = SH.collective_bytes()
        if t < steps - 1:
            got, _ = ring_dc(mp, cache, batch)
        else:       # the same step, every data row's logits kept
            with torch.no_grad(), ctx.activation_sharding(
                    ctx.residual_hooks(mesh, SH.dp_axes(mesh))):
                rows, _ = ring.decode(mp, cache, batch, per_row=True)
            got = rows[0]
            if not all(torch.equal(r, got) for r in rows[1:]):
                raise AssertionError(f"{label}: the data rows' logits "
                                     f"differ on the replicated batch")
        torch.cuda.synchronize()
        ms1.append((t2 - t1) * 1e3)
        ms.append((time.perf_counter() - t2) * 1e3)
        if t == 0:
            coll = _coll_delta(c0)
        errs.append(((got - want).abs().max() / want.abs().max()).item())
    model_coll = _mesh_model_bytes(cfg, LONG_RING, "long", 1, LONG_LEN)
    if model_coll != coll:
        raise AssertionError(f"{label}: the dry run's model {model_coll} "
                             f"!= the ring's counters {coll}")
    if not max(errs) <= tol:
        raise AssertionError(f"{label} long_500k on {LONG_RING}: logits "
                             f"off one device's by {errs} (tol {tol})")
    print(f"  {label} long_500k on a {LONG_RING} ring (batch 1 on every "
          f"data row, cache {cache.spec} of {LONG_LEN} positions, "
          f"{held / 1e9:.2f} GB on the ring): {steps} decode steps at "
          f"positions {LONG_LEN - steps}..{LONG_LEN - 1} within "
          f"{max(errs):.2e} of max |logit| of one device's (by step "
          f"{[f'{e:.2e}' for e in errs]}; tol {tol}); "
          f"every data row's logits equal; decode "
          f"{[round(x, 1) for x in ms]} ms a step against one device's "
          f"{[round(x, 1) for x in ms1]}; collective bytes of a step {coll},"
          f" equal to the dry run's model (a decode step launches no "
          f"kernel: its conv window and attention are torch ops); "
          f"{time.perf_counter() - t0:.1f} s")
    del mp, cache, tree, model
    torch.cuda.empty_cache()
    return {"ms": ms, "one_ms": ms1, "errs": errs, "coll": coll}


def self_gap(torch, cfg, tokens) -> float:
    """One device's f32 prefill of ``tokens`` against itself with its
    embedding table nudged by at most one ulp (scaled by 1 + 2^-23): the
    model's own amplification of one rounding, beside which a ring's gap
    is read (of max |logit|)."""
    from repro_torch.models.transformer import init_params

    model = init_params(cfg, seed=0)
    with torch.no_grad():
        a = model.prefill(tokens=tokens)[0][:, -1]
        model.embed.mul_(1 + 2.0 ** -23)
        b = model.prefill(tokens=tokens)[0][:, -1]
    del model
    torch.cuda.empty_cache()
    return ((a - b).abs().max() / a.abs().max()).item()


def recurrent_mesh_phase(torch, np) -> list:
    """Phase 19c: the hybrid and ssm families on rings of this card.
    bf16 roundings decide how close a ring comes to one device: a TP
    split rounds other partial products, and zamba2-7b's 81 layers carry
    that over like its decode-vs-forward roundings (so its bf16 rings
    are held to ``ORACLE_TOL``, the bound reasoned for those), rwkv6-3b
    amplifies it whatever the precision (ROADMAP §3; its f32 copies are
    held to ``MESH_TOL``, its bf16 gap read in PERF.md).  So:
    zamba2-7b served uncut (bf16) on ``HYBRID_RING`` and, as an f32 copy
    cut to ``HYBRID_CUT`` layers, on ``HYBRID_CUT_RING``; rwkv6-3b (f32
    copy) uncut on ``SSM_RING`` and cut to ``SSM_UNEVEN_LAYERS`` on
    ``SSM_UNEVEN_RING``, beside its own gap under a one-ulp nudge
    (``self_gap``); ``long_500k``'s replicated-batch decode of zamba2
    (cut, bf16, its cache of ``LONG_LEN`` positions) and rwkv6 (f32) on
    ``LONG_RING``; both trained (bf16) in the TP + SP grain on (2, 2),
    rwkv6's first step held (its later steps carry the first's roundings
    through Adam into a model that amplifies them); the rows of
    causal_conv1d and flash at the slice's shard shapes.  Returns the
    rows."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.train import step as S

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"recurrent families on a mesh: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before "
          f"it; rings of this card (no speed is claimed: the shards share "
          f"one card)")
    gen = torch.Generator().manual_seed(31)
    zamba = get_config(LM_ARCH)
    cut = dataclasses.replace(zamba, n_layers=HYBRID_CUT)
    rwkv = get_config(SSM_ARCH)
    rwkv32 = dataclasses.replace(rwkv, dtype="float32")
    prompt = torch.randint(0, zamba.vocab, (2, MESH_PROMPT),
                           generator=gen).cuda()
    served = ring_serve(torch, zamba, (HYBRID_RING,), {"tokens": prompt},
                        None, f"{LM_ARCH} (uncut)", tol=ORACLE_TOL)
    served_cut = ring_serve(
        torch, dataclasses.replace(cut, dtype="float32"),
        (HYBRID_CUT_RING,), {"tokens": prompt}, None,
        f"{LM_ARCH} ({HYBRID_CUT} of {zamba.n_layers} layers, f32 copy)")
    prompt = torch.randint(0, rwkv.vocab, (2, MESH_PROMPT),
                           generator=gen).cuda()
    print(f"  {SSM_ARCH} (uncut, f32 copy) against itself with its "
          f"embedding nudged by one ulp: {self_gap(torch, rwkv32, prompt):.2e}"
          f" of max |logit|")
    ring_serve(torch, rwkv32, (SSM_RING,), {"tokens": prompt}, None,
               f"{SSM_ARCH} (uncut, f32 copy)")
    ring_serve(torch, dataclasses.replace(rwkv32,
                                          n_layers=SSM_UNEVEN_LAYERS),
               (SSM_UNEVEN_RING,), {"tokens": prompt}, None,
               f"{SSM_ARCH} ({SSM_UNEVEN_LAYERS} of {rwkv.n_layers} layers, "
               f"f32 copy)")
    long_decode(torch, cut, f"{LM_ARCH} ({HYBRID_CUT} layers)",
                tol=ORACLE_TOL)
    long_decode(torch, rwkv32, f"{SSM_ARCH} (uncut, f32 copy)",
                steps=SSM_LONG_STEPS)
    mesh = make_mesh_for(2, 2, devices=_ring_devices(torch, MESH_RING))
    plan = S.StepPlan(n_microbatches=1, tp=True)
    for cfg, held, label in (
            (cut, None, f"{LM_ARCH} ({HYBRID_CUT} layers)"),
            (dataclasses.replace(rwkv, n_layers=SSM_TRAIN_LAYERS), 1,
             f"{SSM_ARCH} ({SSM_TRAIN_LAYERS} of {rwkv.n_layers} layers)")):
        g = torch.Generator(device="cuda").manual_seed(32)
        batches = [{k: torch.randint(0, cfg.vocab, (RECURRENT_BATCH,
                                                    MESH_SEQ),
                                     generator=g, device="cuda")
                    for k in ("tokens", "labels")}
                   for _ in range(MESH_STEPS)]
        ring_train(torch, np, cfg, mesh, plan, batches, label, held)
    rows = [conv_shard_row(torch, shape[1], launches["causal_conv1d"], 33)
            for shape, launches in
            ((HYBRID_RING, served["launches"][HYBRID_RING]),
             (HYBRID_CUT_RING, served_cut["launches"][HYBRID_CUT_RING]))]
    rows.append(flash_shard_row(
        torch, HYBRID_FLASH,
        served["launches"][HYBRID_RING]["flash_attention_fwd"],
        "flash_attention_fwd_hybrid_shard",
        f"{LM_ARCH}'s {HYBRID_RING} head shard prefill", 34))
    print(f"recurrent families on a mesh: {time.perf_counter() - t0:.1f} s")
    return rows


def isolate_tune_artifacts() -> str:
    """Point the tune cache and the calibration artifact at a fresh
    temporary directory before anything imports the port, so that no
    earlier tuning run changes this run's picks; returns the directory."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(tmp,
                                                        "tune_cache.json")
    os.environ["REPRO_TORCH_CALIBRATION"] = os.path.join(tmp,
                                                         "calibration.json")
    return tmp


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run this "
              f"script from a checkout of the repository", file=sys.stderr)
        return 2
    tmp = isolate_tune_artifacts()
    try:
        return smoke(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def smoke(torch, tmp: str) -> int:
    sys.path.insert(0, str(SRC))
    import numpy as np

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}; tune "
          f"artifacts in {tmp}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    return phases(torch, np, tmp, card)


def phases(torch, np, tmp: str, card: str) -> int:
    from repro_torch.kernels import cuda_build
    t0 = time.perf_counter()
    cuda_build.load_all(SOURCES)
    print(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for src in SOURCES:
        print(f"ptxas: {src}: "
              f"{ptxas_summary(cuda_build.build_logs.get(src, ''))}")
        counts = tensor_core_counts(cuda_build.build(src)[0])
        hg = sum(c[0] for c in counts.values())
        hm = sum(c[1] for c in counts.values())
        print(f"sass: {src}: {len(counts)} kernels, HGMMA {hg}, HMMA {hm}")
        if src == "flash_attention.cu":
            bf16 = {n: c for n, c in counts.items()
                    if "flash_fwd_bf16_kernel" in n}
            if not bf16 or not all(sum(c) for c in bf16.values()):
                raise AssertionError(f"the bf16 flash kernel issues no "
                                     f"tensor-core instruction: {bf16}")
            f32 = {n: c for n, c in counts.items()
                   if "flash_fwd_kernel" in n}
            if not f32 or not all(c[1] for c in f32.values()):
                raise AssertionError(f"the f32 flash kernel issues no "
                                     f"tensor-core instruction: {f32}")
            check_bf16_bwd_hgmma(counts)
            check_f32_bwd_hmma(counts)
            log = cuda_build.build_logs.get(src, "")
            regs = ptxas_kernels(log, "bf16_kernel")
            print(f"ptxas: the bf16 flash backward's kernels (registers, "
                  f"spill store bytes): "
                  f"{ {n: r for n, r in sorted(regs.items()) if 'bwd' in n} }")
            for line in log.splitlines():
                if "wgmma" in line and "serialized" in line:
                    print(f"ptxas: {line.strip()}")

    errs = {}
    t0 = time.perf_counter()
    n = kernel_phase(torch, errs)
    print(f"kernels: {n} launches held against their plain versions in "
          f"{time.perf_counter() - t0:.1f} s; max abs err "
          f"{ {f'{g}/{d}': e for (g, d), e in sorted(errs.items())} }")

    sched, chain, counts = main_path(torch, np, errs)
    for bucket in (1, 2, 4, 8):
        layer_breakdown(torch, sched, chain, bucket)
    rows = timing_phase(torch, sched, chain, counts, errs)
    train_rows, train_run = train_phase(torch)
    rows += train_rows
    tuned_plans = tune_phase(torch, sched, chain, train_run)

    lm_errs = lm_kernel_phase(torch)
    bwd_split = flash_bwd_split(torch)
    lm_counts, _ = lm_path(torch, np)
    dense = attn_lm_path(torch, np)
    ssm_lm(torch, np)
    rows += lm_timing_phase(torch, lm_counts, lm_errs, dense["counts"])
    hybrid = hybrid_train_step(torch)
    lm_train = lm_train_phase(torch, np)
    lm_errs.update(lm_train["errs"])
    lm_grad_oracle(torch)
    rows += lm_train_rows(torch, lm_train, hybrid, lm_errs, bwd_split)
    analyze_phase(torch, list(sched.registry.plans().values())
                  + [p for _, _, p in train_run["walk"]] + tuned_plans)
    rows += examples_phase(torch, tmp, bwd_split)
    rows += shard_phase(torch, tmp, errs)
    measured = measured_steps(dense, lm_train)
    lm_train.clear()
    mesh = lm_mesh_phase(torch, np, tmp)
    rows.append(mesh["row"])
    rows.append(attn_mesh_phase(torch, np))
    rows += recurrent_mesh_phase(torch, np)
    train_profile(torch, train_run)
    lm_train_profile(torch)
    roofline_phase(measured, mesh)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
