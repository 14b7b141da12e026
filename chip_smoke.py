"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels, holds each against its plain PyTorch version, drives the serving
engine (paged and dense caches), training, eval, the SSM family, the
hybrid family, the dense zoo, the MoE family (with the rolling
sliding-window cache), MLA over the MoE (deepseek-v2-236b, its latent
paged cache), h2o-danube-3-4b (head width 120, a 4096 window), the
VLM backbone internvl2-1b (stub vision tokens) and the encoder-decoder
whisper-tiny (stub audio frames, a cross cache) at full width and prints
what it measured.

    python3 chip_smoke.py

Phases, each printing one JSON line:

- ``env``: torch/CUDA versions, ``nvcc --version``, whether ``triton``
  imports, the card's name and power limit;
- ``build``: compiles ``src/repro_torch/kernels/csrc/*.cu`` (one ``nvcc``
  per source, in parallel) into ``build/kernels/``, while the host draws
  the ``ssm_weights`` and ``hybrid_weights`` below;
- ``kernels``: each kernel against its plain version on the card, f32
  (atol/rtol 2e-5) and bf16 (2e-2): paged attention over the serving
  slice's shapes and the GQA/MQA/MLA/softcap/verify (G 8 x T 5, and
  ds-paper-100m's G 1 x T 5 and T 9)/aliased/parked cases,
  and its bf16 tensor-core path's edges (the ``tc_*`` cases: G*T 16 at
  pages of 8-64 with offsets 0 and straddling a page, G 2 x T 16, a ragged
  G 3 x T 8 fold, dk = dv = 128, a parked row held exactly zero, aliased
  first pages, softcap 30, dk 192 at pages of 8 and 64, a 12-row fold,
  granite's 768-row fold with a parked row and aliased pages, MQA G 48
  over one row of 4096 keys in 16 key splits, qwen2's 128 rows straddling
  a page; each record names the path) and its f32 route's (3xTF32, the
  ``tc_*_f32`` cases: dk 192 at pages of 8 and 64 straddling a page,
  granite's 768-row fold with a parked row and aliased pages, MQA G 48
  decode in 10 and in 16 key splits, softcap 30 at nemotron's 12-row
  decode, 144 rows at dk 128 whose second row group is cut short, the
  mixed widths 64/128 and 128/64), its split-KV decode path's
  edges in f32 and bf16 (the ``dec_*`` cases: one row over 1 and 4096
  keys, mixed long and short rows, pages of 8 and 64, softcap 30 at T 1,
  a G 2 x T 4 fold, GQA G 8 at dk 128, a parked row beside aliased first
  pages), the dense zoo's serving shapes (granite-34b's MQA prefill at
  G 48 x T 16, qwen2-72b's prefill at G 8 x T 16, nemotron-4-340b's decode
  and prefill at dk 192, each on the path ``CASE_PATHS`` names: the
  tensor cores in both dtypes, f32 in 3xTF32; and G 6 x T 16 at dk 128),
  deepseek-v2-236b's MLA fold at full width in both dtypes (one latent
  pool as K and V, B 16, Hkv 1, G 128, dk 576, v_width 512, 128-576 keys,
  at T 1 and T 4, MLA's scale 1/sqrt(192), on the tensor-core path
  (csrc/paged_mla.cu) in bf16 and in f32 (3xTF32)) and the MLA fold's
  edges in both dtypes (the ``mla_tc_*`` cases: a parked row, unallocated
  table entries mid-row, pages of 8, 32 and 64, one row of 4096 keys in
  the most key splits, softcap 5 over split rows, G 16 over 2 rows in one
  partial row group; separate K and V pools at MLA's widths, which the
  CUDA-core path takes in both dtypes, the ``mla_pools_*`` cases), RMSNorm (and its
  gradient; d = 768, mamba2's 2048, zamba2's shared block at 4096, the
  zoo's 6144, 8192 and 18432 and deepseek's 5120, 1536 and 512, each
  record naming its kernel path: all one pass), flash
  attention over the reference's sweep,
  sliding windows, the model layout, and in both dtypes the eval phase's
  shapes and the kernels' edges (S 192 and 320 with a ragged last tile,
  S 1216 with a ragged last 192-row one, ``sq != skv``, windows 32
  and 128, hd 128 and 192, and mixtral's hd 128 with a 4096 window over
  8192 positions; h2o-danube-3-4b's head width 120, at a padded depth of
  128: causal at BH 32 x 512, S 320 causal and not, a 128 window over
  S 1216, its 4096 window over 8192 positions; whisper-tiny's lengths:
  non-causal at S 1,500 and at 448 queries over 1,500 keys, and S 100 and
  1,436, no multiple of 16, causal and not), internvl2-1b's 7-row
  decode fold on the paged kernel's decode path (``dec_vlm_g7_*``),
  whisper's cross cache on that path (``dec_whisper_cross_*``: B 16, Hkv
  6, G 1 over 1,500 keys in pages of 20, offsets 1499) and
  RMSNorm at internvl's 896 (16 and 256 rows, one pass), and
  the SSD chunk kernel over the reference's
  sweep, chunks of 1-16 positions, the serve prefill shape with padded
  tokens and idle rows, mamba2's eval shapes, zamba2's (state 64) serve
  prefill and eval shapes (bf16 at 1e-4 as well as 2e-2, and on mamba2's
  eval shapes the kernel's outputs rounded to bf16 must miss 1e-4), and
  ``ops.ssd`` from a carried state (final state at 1e-4);
- ``parity``: full-width ``ds-paper-100m`` in f32 from seed 0, the engine
  on ``cuda`` (kernel path) against the same engine on ``cpu`` (plain
  path), in paged mode (12 paged-attention launches per dispatch, exact by
  path: a prefill dispatch's on the tensor-core path in 3xTF32, a decode
  dispatch's on the decode path; and 25 RMSNorm) and in dense mode, now the
  engine's default as in the reference (25 RMSNorm, no paged launch):
  equal greedy tokens (a near-tie below 1e-3 of the CPU's top-2 logit gap
  is the one allowed exception) and counters, and dense tokens equal to
  paged ones;
- ``serve``: full width in bf16, paged, 32 requests, tokens/s,
  per-dispatch times from CUDA events, peak memory, 12 tensor-core paged
  launches per prefill dispatch, 12 decode-path ones per decode dispatch
  and none on the CUDA-core path, and each kernel at the decode and
  prefill shapes (the paged kernel also at ``decode_long``: 16 rows of
  2048-4096 keys, and at parity's f32 chunk-extend shape: 4 rows of 16
  tokens, 8 pages a slot, on the tensor-core path and forced onto the
  CUDA-core one), held against its plain
  version and timed beside its bound, its plain version and one PyTorch
  call as a yardstick (RMSNorm also beside an empty launch through the
  same library, ``launch_floor_ms``);
- ``profile``: 16 decode dispatches at the serve shape timed on the host
  clock, then 16 more traced with ``torch.profiler``: device busy time,
  idle share against the unprofiled wall time, top device ops;
- ``spec_parity``: f32, the first 2 of the 12 layers (the depth cut keeps
  its CPU side short), the speculative engines (paged ``ngram`` and
  ``draft``, dense ``ngram``, ``spec_k`` 4: verify at T 5; the draft is
  the same arch from seed 7) and the grouped engine on the card against
  the same engines on the CPU: equal greedy tokens (the near-tie
  exception) and counters, speculative ones included, tokens equal to the
  non-speculative paged and dense card engines at that depth, 4
  decode-path paged launches and 9 RMSNorm per verify dispatch, 9 RMSNorm
  per dispatch draft dispatches included, and a draft run that rolls back;
- ``spec_serve``: bf16, paged, 2 of the 12 layers (a depth cut for the
  time limit), 8 decode-heavy requests of 256 new tokens
  through the plain engine, ``ngram`` at ``spec_k`` 8 (verify T 9: the
  tensor-core path) and ``draft`` at ``spec_k`` 4 (T 5: the decode path):
  tokens/s, dispatches per token, accepted per dispatch, verify dispatch
  times from CUDA events, launches by path, peak memory, tokens against
  the plain run (reported, not gated: bf16 verify rounds unlike T
  sequential decodes), a traced verify tick each, and the paged kernel at
  the verify shapes (B 16, T 5 and 9, 128-576 keys) beside its bound,
  plain version and SDPA;
- ``ds_parity``: the control plane and its payloads on the card, f32
  full-width ``ds-paper-100m`` from seed 0, through the paper's four
  commands (``run_ds.main``, ``startCluster --foreground`` so the worker
  threads' launches are counted; no job names a device, so each runs on
  cuda): 2 train spans of 2 steps at 4 x 256 against one direct 4-step
  span (2 of the 12 layers, a depth cut; losses, parameters at
  ``train_parity``'s tolerances), 2 eval shards on that checkpoint
  against direct ``run_eval`` (2 flash and 5 RMSNorm a forward), a static
  serve job and a streaming lease of ``parity``'s 6 requests against
  ``parity``'s card engine (tokens, counters; 12 paged and 25 RMSNorm a
  dispatch; the request queue ends empty), two streaming leases of 3
  requests at once on the card (launches the exact sum of both), a seeded
  revocation drill on the ``SimRunner`` (one notice; every request served
  once, checkpoint resumes, tokens equal an uninterrupted run's) and a
  static ``mamba2-1.3b`` job at 3 of its 48 layers against a direct
  engine (3 SSD launches a prefill dispatch);
- ``ds_serve``: ``serve``'s 32 requests in bf16 at 2 of the 12 layers (a
  depth cut) in one call: the bare
  engine, the lease payload called directly (no runner) and one streaming
  lease in the foreground, in turns (the queue's, the object store's, the
  engine's and the rest's shares of each foreground lease's wall time,
  timed in its worker thread; queue transactions per engine tick; one
  more lease under cProfile for its top self-time functions) and the
  detached flow (``startCluster`` spawns the worker
  host, ``monitor`` polls until the queue drains, the host's summary);
  tokens/s of each, peak memory of the lease beside the bare engine's;
  every request served and acked, detached completions equal to the
  foreground's;
- ``ds_store``: the cross-host prefix store and disaggregated
  prefill/decode leases at page size 16.  f32 gates through the runtime
  on the ``SimRunner``: two static jobs sharing a 32-token system prompt
  (one worker publishes 2 pages, the other hydrates them; tokens equal a
  card engine without a store, counters equal the same scenario on the
  CPU), a prefill lease and a decode lease over ``parity``'s 6 requests
  (6 handoffs published and admitted, no fallback, the prefill side
  emits nothing, tokens equal ``parity``'s card engine, both queues
  empty), and that split again with one page truncated by the chaos
  monkey between the leases (the miss and one fallback counted, tokens
  still equal); 12 paged and 25 RMSNorm launches a dispatch, every
  hydrated page bit-equal to the publisher's pool page.  bf16 numbers (2
  of the 12 layers):
  ``serve``'s 32 requests behind a shared 256-token system prompt, in
  turns, one unified lease with the store and a prefill lease followed
  by a decode lease: tokens/s, pages and bytes published and hydrated,
  host ms per page by step, the store's share of each lease's wall time,
  peak memory, the split's tokens against the unified lease's (reported);
- ``train_parity``: full-width f32 training at 1 of the 12 layers (the
  depth cut keeps its CPU side short), 2 x 128 tokens, AdamW steps on
  the card against the same steps on the CPU from the same weights and
  batches (loss, grad norm, parameters), 2 as one batch and 1 as 2
  microbatches with int8 stochastic-rounding accumulation;
- ``family_train_parity``: the same f32 steps (TF32 off, 2 x 128; 2 for
  mamba2 and zamba2, 1 for mixtral and deepseek)
  through the payload's ``build_model``/``build_train_step`` for each
  family past ds-paper-100m at full width: ``mamba2-1.3b``'s first layer
  and ``zamba2-1.2b``'s first 7 (a shared-block invocation with its LoRA,
  ``lora_b`` at zero, and a trailing layer) cut from ``ssm_weights`` and
  ``hybrid_weights``, ``mixtral-8x7b`` at 1 layer under ``capacity`` and
  ``deepseek-v2-236b``'s dense first layer (MLA and the 12,288-wide MLP),
  drawn on the card; card against CPU at 1e-4 (loss, grad norm, every
  parameter), RMSNorm launches exact, ``lora_a`` moved by its gradient;
  step ms, tokens/s, peak memory, card and CPU seconds;
- ``remat_train``: ``mamba2-1.3b`` under ``ModelRuntime(remat=True)``
  through ``make_train_step`` at 2 x 4096, f32 (TF32 off): its first 4
  layers 2 steps with remat against 2 without (equal within rel 1e-6, a
  lower peak, each layer's RMSNorm launched again in the recompute), the
  bytes a forward leaves held; then all 48 layers, 3 steps with remat
  (the last traced): finite losses, step ms, tokens/s, peak memory, and
  the peak without remat predicted, not run;
- ``mesh``: the model over a (1, 1) ("data", "model") ``DeviceMesh`` on
  the card (NCCL over one rank through a ``FileStore``) under
  ``train_rules`` with FSDP over "data", every parameter a DTensor laid
  out by ``param_specs``, against the same runs unsharded: (a)
  ds-paper-100m at full width, 2 layers, f32: the loss and every leaf's
  gradient at 1e-4 (reported bit for bit or not), RMSNorm through
  ``local_map`` onto the kernel, launches equal; (b) its bf16 eval
  forward: logits within 1e-1, flash and RMSNorm launches equal; (c) one
  full-width mixtral-8x7b layer in f32, ``shardmap`` against
  ``capacity``: output at 2e-5, gradients at 1e-4 of each leaf's largest;
  (d) ``pipeline_apply`` on a one-stage pipe at d 768; NCCL's start-up
  seconds; a mesh of another size than the world raises.  Multi-rank
  meshes run only on the CPU (the tests): the machine has one card;
- ``roofline``: ds-paper-100m's ``serve_paged_32k`` decode step at full
  width (B 128, max_len 32,768, pages of 128, a pool of 16,384) on the
  card's one rank (a (1, 1) layout) at 12, 2 and 4 layers against the
  port's own count of it (``launch.dryrun``): the inputs' bytes on the
  card equal to ``_analytic_arg_bytes``, the step's peak against the
  projection, the count's compute, memory and bound terms (its bytes no
  fewer than the pools and weights the step reads), the median of 25
  steps and the share bound / measured (at most 1.05), L paged and
  2 L + 1 RMSNorm launches a step, the reference's differencing of the
  2- and 4-layer times against the 12-layer time; at 2 layers the paged
  kernel (within 1/64 of its largest output, a check shown to fail an
  output with a page or a split a row dropped) and RMSNorm against their
  plain versions at the cell's shapes;
- ``train``: full width in f32 at 2 of the 12 layers (a depth cut), 8 x
  512 tokens, 20 steps through the span
  runner into a checkpoint, resumed for 2 more and held against an
  uninterrupted 22-step run: losses, step times, tokens/s, peak memory,
  and one step traced with ``torch.profiler``;
- ``eval``: full-width forward (``train``'s 2 layers) through the eval
  runner in bf16 and f32 at 8 x 512 and 2 x 4096: tokens/s, 2 flash and 5
  RMSNorm launches
  per forward, logits with the flash kernel against direct attention, a
  traced forward, and the flash kernel timed beside its bound (f32: three
  TF32 passes, its route, with the CUDA-core figure beside it), its plain
  version and ``F.scaled_dot_product_attention``;
- ``ssm_weights``: full-width ``mamba2-1.3b`` (48 layers at d_model
  2048), drawn once from seed 0 on the host during the build, reused
  below;
- ``ssm_parity``: f32, the first 4 of those layers (the depth cut keeps
  the CPU side short and pays for the later phases), the dense-cache
  engine on the card against the same engine on the CPU: equal greedy
  tokens and counters, 4 SSD launches per prefill dispatch, none per
  decode dispatch, 5 RMSNorm per dispatch;
- ``ssm_serve``: bf16, dense cache, the first 6 of the 48 layers (a depth
  cut), 32 requests: tokens/s, per-dispatch
  times, peak memory, 16 decode dispatches traced, the SSD kernel at the
  serve prefill shape and RMSNorm at d = 2048 timed beside their bounds;
- ``ssm_eval``: the eval runner on a bf16 checkpoint of the same weights
  written with the port's ``save_state``, bf16 and f32 at 8 x 512 and
  2 x 4096: finite loss, 48 SSD and 49 RMSNorm launches per forward,
  logits with the SSD kernel against the plain chunked scan (f32 within
  1e-3; bf16 by ``witness_gate``, as ``hybrid_eval``, with the SSD
  controls), a traced forward, and the SSD kernel timed at both shapes
  beside its bound on the route it takes (``bound_route``: f32 C.B^T on
  the CUDA cores and the rest 3xTF32; bf16 C.B^T one bf16 pass and the
  rest three), the CUDA-core figure beside it;
- ``hybrid_weights``: full-width ``zamba2-1.2b`` (38 mamba2 layers at
  d_model 2048, state 64; one shared attention block at 4096, 32 heads of
  128, run before each of 6 segments of 6 layers with its own LoRA of rank
  128 on ``wq``; 1.29 B parameters) from seed 0 on the host during the
  build, ``lora_b``
  drawn non-zero (its reference init is zeros) and said so on a line;
- ``hybrid_parity``: f32, the first 8 of the 38 layers (one full
  segment and 2 trailing layers), ``ssm_parity``'s knobs and
  ``parity``'s 6 requests, the card against the CPU: equal greedy tokens
  and counters, 8 SSD launches a prefill dispatch and none a decode one,
  11 RMSNorm a dispatch all on the one-pass path, no flash or paged
  launch;
- ``hybrid_serve``: bf16, the first 8 of the 38 layers (one segment and
  the trailing 2), ``ssm_serve``'s 32 requests and knobs: tokens/s,
  per-dispatch times, peak memory, the same launches; 16 decode dispatches
  traced and the per-invocation LoRA merge timed alone for its share;
  RMSNorm at 16 and 256 x 4096 and the SSD kernel at state 64 timed;
- ``hybrid_static``: ``parity``'s 6 requests as a static bf16
  ``distributed-serve`` job through the four commands, serving a bf16
  checkpoint of those weights: completions and counters equal to a
  direct engine on the card, the same launches as ``hybrid_parity``;
- ``hybrid_eval``: the eval runner on that checkpoint, bf16 and f32 at
  8 x 512 and 2 x 4096: finite loss, 38 SSD, 51 RMSNorm and 6 flash
  launches (hd 128) a forward; f32 logits with the kernels within 1e-3
  of the plain path (``use_ssd_kernel=False``, ``attn_impl="direct"``),
  the gate of ``eval`` and ``ssm_eval``; bf16 logits held to an f32 run
  of the same weights (``witness_gate``), each batch row's mean distance
  at most 1.04 times the plain path's, with faults put into the kernels'
  outputs that must each exceed it where their f32 run misses the 1e-1
  comparison (which no two bf16 routes of this model meet, and which is
  reported); flash at hd 128 and SSD at state 64
  timed at each shape.  It holds its logits gates after emitting its
  numbers;
- ``zoo_parity``: the dense zoo in f32 (TF32 off), weights drawn on the
  card (``Model.draw``; qwen2-72b's QKV bias drawn non-zero, its reference
  init being zeros), ``parity``'s 6 requests through the paged and the
  dense engine, 2 new tokens each (``parity``'s 24 cut for the time
  limit: the CPU side's decode dispatches): granite-34b and qwen2-72b at 1 layer, the card
  against the CPU (a CPU copy of the card's tree); nemotron-4-340b at 1
  layer (51.6 GB in f32), the card's paged engine without its prefix
  cache against its dense engine: equal greedy tokens (the near-tie
  exception), counters and every dispatch's logits at 1e-4, launches
  exact by path (``ZOO_PATHS``: every f32 fold on the tensor-core path in
  3xTF32 but qwen2's 8-row decode, on the decode path), RMSNorm all
  one-pass;
- ``zoo_serve``: bf16, ``serve``'s 32 requests through the paged engine,
  granite-34b at 3 of its 88 layers, qwen2-72b at 4 and nemotron-4-340b
  at 2, each freed before the next: tokens/s, dispatch times, peak
  memory, launches exact by path, a traced decode dispatch, and the paged
  kernel and RMSNorm at the model's decode and prefill shapes timed
  beside their bounds, plain versions and library calls;
- ``moe_parity``: ``mixtral-8x7b`` at 1 layer in f32 (TF32 off; 1.72 B
  parameters, 6.9 GB), weights drawn on the card, 16 requests (prompts
  8-16, 8 new, ``max_batch`` 16; 16-48, then 8-24, before cuts for the
  time limit, ``MOE_PARITY_PROMPTS``) through the dense-cache engine, every
  prompt ingested one token a decode dispatch (MoE takes no fused
  prefill), on the card against the same engine on the CPU, under
  ``capacity`` (5 slots an expert at 16 rows: entries drop, counted) and
  ``dense``: equal greedy tokens (the near-tie exception), every counter,
  every dispatch's logits at 1e-4, 3 one-pass RMSNorm a dispatch;
- ``moe_window``: the same weights, ``dense``, 2 rows decoded one
  position at a time through 4,608 positions of the 4,224-slot rolling
  cache: each position's logits against one windowed full forward on the
  plain chunked path (1e-4) and through the flash kernel (1e-3), and a
  forward without the window that must miss past position 4096;
- ``moe_serve``: 2 layers in bf16 (6.1 GB), ``serve``'s 32 requests on
  the dense cache under ``dense`` (the entry points' default): tokens/s,
  dispatch times, peak memory, 5 one-pass RMSNorm a dispatch, 8 decode
  dispatches traced (GEMM and routing device time); a ``capacity`` run's
  tokens/s beside it;
- ``moe_eval``: 2 layers over 1 x 8192 tokens, ``dense``: f32 logits
  with the kernels (flash at hd 128 with the 4096 window, RMSNorm)
  within 1e-3 of the plain path (chunked attention, plain RMSNorm), 2
  flash and 5 RMSNorm a forward; bf16 timed and reported; flash at BH 32
  x 8192 timed in both dtypes beside its bound (the windowed pair count),
  its plain version and SDPA given the window as a boolean mask;
- ``mla_parity``: ``deepseek-v2-236b`` at 2 of its 60 layers (the dense
  first layer and one MoE layer of 160 experts, top 6, 2 shared) in f32,
  TF32 off (5.36 B parameters, 21.4 GB), weights drawn on the card, 16
  requests (prompts 4-8, 4 new, ``max_batch`` 16, page 16; 8-24, then
  4-12, before cuts for the time limit, ``MLA_PARITY_PROMPTS``) through the
  paged engine, every prompt ingested one token a decode dispatch, on the
  card against the same engine on the CPU, under ``capacity`` (drops
  counted, required) and ``dense``: equal greedy tokens (the near-tie
  exception), every counter, every dispatch's logits at 1e-4, a paged
  launch a layer a dispatch on the tensor-core path (the f32 latent fold B
  16 x G 128, dk 576, v_width 512, in 3xTF32) and 4 L + 1 one-pass
  RMSNorm; the dense
  ``c_kv``/``k_rope`` engine on the card against the paged one (tokens,
  logits at 1e-4); one ``Model.forward`` of 2 x 128 tokens under
  ``capacity`` card against CPU at 1e-4;
- ``mla_serve``: 2 layers in bf16 (the dense first layer and one MoE
  layer: 5.36 B, 10.7 GB), ``serve``'s 32
  requests through the paged engine under ``dense``: tokens/s, dispatch
  wall median and p99, peak memory, the latent cache's peak bytes beside
  a per-head cache's for the same pages, launches exact, 8 decode
  dispatches traced (GEMM, paged, RMSNorm and routing device time), and
  the paged kernel at the MLA fold (T 1 and 4, both dtypes, each also
  forced onto the CUDA-core path) and RMSNorm at 5120, 1536 and 512 timed
  beside their bounds (the paged kernel's on the tensor cores, f32 as
  three TF32 passes, and on the CUDA cores), plain versions and SDPA /
  ``F.rms_norm``;
- ``danube_parity``: ``h2o-danube-3-4b`` at 1 of its 24 layers in f32
  (TF32 off), weights drawn on the card, 4 requests (prompts 24-48, 16
  new, ``max_batch`` 4, 64 positions: under the window, so the fused
  prefill) through the dense engine on the card against the same engine
  on the CPU: equal greedy tokens (the near-tie exception), every counter,
  every dispatch's logits at 1e-4, 3 one-pass RMSNorm at 3840 a dispatch;
- ``danube_serve``: 12 of its 24 layers in bf16 on the rolling cache
  (4,608 positions a row, 4,224 slots under the 4096 window: 3.1 GB at 16
  rows), 16 requests of 128 tokens, 64 new, every prompt ingested one
  token a decode dispatch: tokens/s, dispatch wall median and p99, peak
  memory, 25 one-pass RMSNorm a dispatch and nothing else launched, a
  traced decode dispatch (busy, idle share, ops, RMSNorm's device time),
  RMSNorm at 16 x 3840 timed;
- ``danube_eval``: 12 of the 24 layers over 1 x 8192 tokens of the eval runner's
  stream: f32 (TF32 off) logits with the kernels (flash at hd 120 with
  the 4096 window, RMSNorm) within 1e-3 of the plain path (chunked
  attention, plain RMSNorm), 12 flash and 25 one-pass RMSNorm a forward,
  a finite loss; bf16 timed and reported (its distance from the f32 plain
  path); flash at BH 32 x 8192, hd 120, window 4096 timed in both dtypes
  beside its bound (the windowed pairs at 120, not the padded 128), its
  plain version and SDPA given the window as a boolean mask, and causal
  at BH 32 x 512;
- ``vlm_parity``: ``internvl2-1b`` at 2 of its 24 layers in f32, its QKV
  bias drawn non-zero, ``danube_parity``'s requests through the paged
  engine (page 16), every prompt ingested one token a decode dispatch
  (a VLM takes no fused prefill), card against CPU as ``danube_parity``:
  a paged launch a layer a dispatch, all on the decode path (the 7-row
  fold), 5 one-pass RMSNorm at 896 a dispatch;
- ``vlm_serve``: 12 of its 24 layers in bf16, 16 requests of 128
  tokens, 32 new, on the paged engine: ``danube_serve``'s numbers, 24
  decode-path paged launches and 25 one-pass RMSNorm a dispatch; the
  paged kernel at the G 7 decode fold (B 16, Hkv 2, dk 64, 128-158 keys)
  in both dtypes and RMSNorm at 896 (16 and 256 rows) timed beside their
  bounds, plain versions and SDPA on pre-gathered K/V / ``F.rms_norm``;
- ``vlm_eval``: 12 of the 24 layers over 8 rows of 256 patches (``SyntheticLM``'s,
  drawn by ``prng.normal``) and 768 tokens, S 1024: f32 held at 1e-3
  against the plain path with 12 flash (hd 64) and 25 one-pass RMSNorm a
  forward and a finite loss, bf16 reported; flash at BH 112 x 1024, hd 64
  timed in both dtypes beside its bound, plain version and SDPA;
- ``whisper_parity``: ``whisper-tiny`` whole (4 encoder and 4 decoder
  layers, d 384, 6 heads of 64, 1,500 frames) in f32, TF32 off, weights
  drawn on the host and moved through the bridge, card against CPU: the
  dense engine on 4 requests (prompts 8-48, 16 new), every prompt ingested
  one token a decode dispatch, every dispatch's logits at 1e-4, tokens and
  counters equal, exactly 4 paged launches a dispatch (each decoder
  layer's cross attention over the cross cache's page view), all on the
  decode path; ``decode_step`` on 2 rows over 32 tokens with the cross
  cache filled from ``SyntheticLM``'s frames, each step at 1e-4; one
  forward at 2 x 448: exactly 12 flash launches (4 encoder, non-causal
  over 1,500; 4 causal self; 4 cross, 448 x 1,500);
- ``whisper_serve``: bf16, the dense engine, 16 requests (prompts 16-64,
  128 new, ``max_len`` 448): tokens/s, dispatch wall median and p99, peak
  memory, 4 decode-path paged launches a dispatch and nothing else, a
  traced decode dispatch, LayerNorm timed alone; the paged kernel over
  the cross cache (B 16, Hkv 6, G 1, 1,500 keys in pages of 20) timed in
  both dtypes beside its byte bound, plain version and SDPA;
- ``whisper_eval``: 16 x (1,500 frames + 448 tokens) from ``SyntheticLM``:
  f32 through the kernels held at 1e-3 against the plain path, 12 flash
  launches a forward, a finite loss, bf16 reported; flash at the
  encoder's BH 96 x 1,500 and cross attention's 96 x 448 x 1,500 (both
  non-causal) and the decoder's 96 x 448 (causal) timed in both dtypes
  beside its bound, plain version and SDPA.

A ``lap`` line after each phase gives its seconds.  Then a
``kernels`` summary line (the paged kernel's and RMSNorm's launches
also per kernel path), the card's ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero before the last line.  Needs one CUDA device; exits
non-zero without a result when there is none or when run outside a
checkout of the repository.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
F32_TOL = 2e-5
BF16_TOL = 2e-2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / fp32 non-tensor
TF32_OPS = 494.7e12  # dense TF32 tensor cores
GIB = 1024 ** 3


class CheckFailed(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def release_device_memory() -> None:
    """Free what earlier phases left (an engine and its scheduler reference
    each other, so only the cycle collector frees an engine's parameters
    and cache) before a phase reads its peak memory."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


# ------------------------------------------------------------------ env / build
def phase_env() -> dict:
    from repro_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60)
    try:
        import triton  # noqa: F401

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    rec = {
        "phase": "env",
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc.stdout.strip().splitlines()[-1] if nvcc.stdout else None,
        "triton": triton_version,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi_line(),
    }
    emit(rec)
    return rec


def phase_build(verbose: bool = False) -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=verbose)
    _build.library()
    rec = {"phase": "build", "seconds": time.perf_counter() - t0,
           "library": str(path.relative_to(ROOT))}
    emit(rec)
    return rec


# ------------------------------------------------------------------ kernel checks
def tol(dtype) -> float:
    return BF16_TOL if dtype == torch.bfloat16 else F32_TOL


def paged_inputs(*, B, hkv, g, T, dk, ps, P, offsets, dtype, seed, dv_store=None,
                 shared_kv=False, n_pages=None, alias=False, parked=(), holes=()):
    """Random pools and a page table backing each row's positions
    [0, offsets[b] + T) with distinct physical pages (the allocator
    invariant), sentinel elsewhere; ``alias`` maps every row's first page
    to one physical page; ``parked`` rows hold only sentinels; the logical
    pages ``holes`` of every row are left unallocated (sentinels)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    need = [-(-(int(o) + T) // ps) for o in offsets]
    n_pages = n_pages or sum(need) + 3
    dv_store = dv_store or dk
    kp = torch.randn((n_pages, ps, hkv, dk), generator=gen, device="cuda").to(dtype)
    vp = kp if shared_kv else torch.randn(
        (n_pages, ps, hkv, dv_store), generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device="cuda").tolist()
    table = torch.full((B, P), n_pages, dtype=torch.int32)
    shared = perm.pop()
    for b in range(B):
        if b in parked:
            continue
        for j in range(need[b]):
            if j not in holes:
                table[b, j] = shared if (alias and j == 0) else perm.pop()
    q = torch.randn((B, hkv, g * T, dk), generator=gen, device="cuda").to(dtype)
    return q, kp, vp, table.cuda(), torch.as_tensor(offsets, dtype=torch.int32).cuda()


def paged_cases():
    """(name, kwargs for paged_inputs, softcap, v_width)."""
    ragged4 = [0, 37, 130, 500]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        d = {"dtype": dtype}
        tag = "f32" if dtype == torch.float32 else "bf16"
        cases += [
            (f"slice_decode_{tag}", dict(B=4, hkv=12, g=1, T=1, dk=64, ps=16, P=40,
                                         offsets=ragged4, seed=1, **d), 0.0, 0),
            (f"slice_prefill_{tag}", dict(B=4, hkv=12, g=1, T=16, dk=64, ps=16, P=40,
                                          offsets=[0, 32, 128, 480], seed=2, **d), 0.0, 0),
            (f"gqa_{tag}", dict(B=3, hkv=8, g=8, T=1, dk=128, ps=16, P=40,
                                offsets=[5, 300, 77], seed=3, **d), 0.0, 0),
            (f"mqa_{tag}", dict(B=2, hkv=1, g=48, T=1, dk=128, ps=16, P=40,
                                offsets=[200, 9], seed=4, **d), 0.0, 0),
            (f"mla_{tag}", dict(B=2, hkv=1, g=16, T=1, dk=576, ps=16, P=40,
                                offsets=[150, 31], seed=5, shared_kv=True, **d), 0.0, 512),
            (f"softcap30_{tag}", dict(B=3, hkv=12, g=1, T=16, dk=64, ps=16, P=40,
                                      offsets=[0, 48, 200], seed=6, **d), 30.0, 0),
            (f"verify_T5_{tag}", dict(B=3, hkv=8, g=8, T=5, dk=128, ps=16, P=40,
                                      offsets=[17, 0, 250], seed=7, **d), 0.0, 0),
            # ds-paper-100m's verify dispatch (G 1): spec_k 4 on the decode
            # path, spec_k 8 on the tensor-core one (f32 in 3xTF32);
            # page-crossing offsets
            (f"verify_g1_T5_{tag}", dict(B=4, hkv=12, g=1, T=5, dk=64, ps=16, P=40,
                                         offsets=[0, 13, 130, 571], seed=14, **d), 0.0, 0),
            (f"verify_g1_T9_{tag}", dict(B=4, hkv=12, g=1, T=9, dk=64, ps=16, P=40,
                                         offsets=[0, 9, 128, 567], seed=15, **d), 0.0, 0),
            (f"aliased_{tag}", dict(B=3, hkv=12, g=1, T=1, dk=64, ps=16, P=40,
                                    offsets=[20, 20, 40], seed=8, alias=True, **d), 0.0, 0),
            (f"parked_{tag}", dict(B=3, hkv=12, g=1, T=1, dk=64, ps=16, P=40,
                                   offsets=[20, 33, 70], seed=9, parked=(1,), **d), 0.0, 0),
            # pages smaller and larger than the kernel's 32-key tile
            (f"page8_{tag}", dict(B=3, hkv=12, g=1, T=16, dk=64, ps=8, P=80,
                                  offsets=[0, 9, 300], seed=10, **d), 0.0, 0),
            (f"page64_{tag}", dict(B=3, hkv=8, g=8, T=1, dk=128, ps=64, P=10,
                                   offsets=[0, 70, 400], seed=11, **d), 0.0, 0),
        ]
    # the bf16 tensor-core path's edges (G*T >= 9 at dk, dv in {64, 128};
    # any fold at 192): page sizes 8-64 with offsets 0 and straddling a
    # page, 32 and a ragged 24 folded rows, dk = dv = 128, a parked row,
    # aliased first pages
    bf = {"dtype": torch.bfloat16}
    for ps in (8, 16, 32, 64):
        cases.append((f"tc_page{ps}_bf16", dict(B=3, hkv=4, g=1, T=16, dk=64, ps=ps, P=8,
                                                offsets=[0, ps // 2 + 3, 5 * ps - 7],
                                                seed=30 + ps, **bf), 0.0, 0))
    cases += [
        ("tc_g2_t16_bf16", dict(B=3, hkv=6, g=2, T=16, dk=64, ps=16, P=40,
                                offsets=[0, 21, 300], seed=31, **bf), 0.0, 0),
        ("tc_g3_t8_ragged24_bf16", dict(B=3, hkv=4, g=3, T=8, dk=64, ps=16, P=40,
                                        offsets=[3, 40, 129], seed=32, **bf), 0.0, 0),
        ("tc_dk128_bf16", dict(B=2, hkv=4, g=1, T=16, dk=128, ps=16, P=40,
                               offsets=[0, 77], seed=33, **bf), 0.0, 0),
        ("tc_parked_bf16", dict(B=3, hkv=12, g=1, T=16, dk=64, ps=16, P=40,
                                offsets=[20, 33, 70], seed=34, parked=(1,), **bf), 0.0, 0),
        ("tc_aliased_bf16", dict(B=3, hkv=12, g=1, T=16, dk=64, ps=16, P=40,
                                 offsets=[20, 20, 40], seed=35, alias=True, **bf), 0.0, 0),
        ("tc_softcap30_page8_bf16", dict(B=3, hkv=4, g=1, T=16, dk=64, ps=8, P=80,
                                         offsets=[0, 13, 200], seed=36, **bf), 30.0, 0),
    ]
    # the split-KV decode path's edges (G*T <= 8, dk and dv in {64, 128}),
    # both dtypes: one row (the fewest blocks) over 1 key and over 4096
    # keys (256 pages), long and short rows in one batch, pages of 8 and
    # 64, a softcap, a G 2 x T 4 fold, GQA G 8 at dk 128 over 4096 keys
    # (the gqa, page64, aliased and parked cases above take this path too)
    for dtype in (torch.float32, torch.bfloat16):
        d = {"dtype": dtype}
        tag = "f32" if dtype == torch.float32 else "bf16"
        cases += [
            (f"dec_b1_ctx1_{tag}", dict(B=1, hkv=12, g=1, T=1, dk=64, ps=16, P=8,
                                        offsets=[0], seed=40, **d), 0.0, 0),
            (f"dec_b1_ctx4096_{tag}", dict(B=1, hkv=12, g=1, T=1, dk=64, ps=16, P=256,
                                           offsets=[4095], seed=41, **d), 0.0, 0),
            (f"dec_ctx4096_mixed_{tag}", dict(B=4, hkv=12, g=1, T=1, dk=64, ps=16, P=256,
                                              offsets=[4095, 0, 2500, 130], seed=42, **d),
             0.0, 0),
            (f"dec_page8_{tag}", dict(B=3, hkv=12, g=1, T=1, dk=64, ps=8, P=80,
                                      offsets=[0, 9, 600], seed=43, **d), 0.0, 0),
            (f"dec_page64_{tag}", dict(B=3, hkv=12, g=1, T=1, dk=64, ps=64, P=10,
                                       offsets=[0, 70, 630], seed=44, **d), 0.0, 0),
            (f"dec_softcap30_{tag}", dict(B=3, hkv=12, g=1, T=1, dk=64, ps=16, P=40,
                                          offsets=[0, 48, 600], seed=45, **d), 30.0, 0),
            (f"dec_g2_t4_{tag}", dict(B=3, hkv=6, g=2, T=4, dk=64, ps=16, P=40,
                                      offsets=[0, 21, 300], seed=46, **d), 0.0, 0),
            (f"dec_gqa8_dk128_ctx4096_{tag}", dict(B=2, hkv=8, g=8, T=1, dk=128, ps=16, P=256,
                                                   offsets=[4095, 777], seed=47, **d), 0.0, 0),
            (f"dec_parked_aliased_{tag}", dict(B=4, hkv=12, g=1, T=1, dk=64, ps=16, P=40,
                                               offsets=[20, 33, 20, 400], seed=48, alias=True,
                                               parked=(1,), **d), 0.0, 0),
        ]
    # the dense zoo's full-width serving shapes the cases above miss (mqa_*,
    # gqa_* and dec_gqa8_dk128_* hold their decode): granite's MQA prefill
    # (G 48 x T 16), qwen2's prefill (G 8 x T 16: 8 M-tiles, past the 6 the
    # tensor-core path's shared memory holds at dk 128), nemotron's decode
    # and prefill at dk 192; and the tensor-core path's most rows at dk 128
    # (G 6 x T 16); each must take the path CASE_PATHS names
    for dtype in (torch.float32, torch.bfloat16):
        d = {"dtype": dtype}
        tag = "f32" if dtype == torch.float32 else "bf16"
        cases += [
            (f"zoo_granite_prefill_{tag}", dict(B=4, hkv=1, g=48, T=16, dk=128, ps=16, P=40,
                                                offsets=[0, 32, 131, 480], seed=50, **d), 0.0, 0),
            (f"zoo_qwen2_prefill_{tag}", dict(B=4, hkv=8, g=8, T=16, dk=128, ps=16, P=40,
                                              offsets=[0, 21, 128, 600], seed=51, **d), 0.0, 0),
            (f"zoo_nemotron_decode_{tag}", dict(B=4, hkv=8, g=12, T=1, dk=192, ps=16, P=40,
                                                offsets=[0, 37, 300, 639], seed=52, **d), 0.0, 0),
            (f"zoo_nemotron_prefill_{tag}", dict(B=4, hkv=8, g=12, T=16, dk=192, ps=16, P=40,
                                                 offsets=[0, 32, 129, 480], seed=53, **d),
             0.0, 0),
        ]
    cases.append(("tc_dk128_rows96_bf16", dict(B=3, hkv=8, g=6, T=16, dk=128, ps=16, P=40,
                                               offsets=[0, 45, 600], seed=54, **bf), 0.0, 0))
    # deepseek-v2-236b's MLA fold at full width: one latent pool passed as K
    # and V (Hkv 1, G 128 query heads, dk 576, values from the first 512
    # columns), 16 rows of 128-576 keys at decode (128 folded rows) and a
    # T 4 chunk-extend (512 rows, a dense-family MLA's fused prefill); the
    # tensor-core path in both dtypes (CASE_PATHS)
    mla_offsets = np.random.default_rng(61).integers(128, 576, 16).tolist()
    for dtype in (torch.float32, torch.bfloat16):
        d = {"dtype": dtype}
        tag = "f32" if dtype == torch.float32 else "bf16"
        cases += [
            (f"mla_full_decode_{tag}", dict(B=16, hkv=1, g=128, T=1, dk=576, ps=16, P=40,
                                            offsets=mla_offsets, seed=62, shared_kv=True, **d),
             0.0, 512),
            (f"mla_full_t4_{tag}", dict(B=16, hkv=1, g=128, T=4, dk=576, ps=16, P=40,
                                        offsets=mla_offsets, seed=63, shared_kv=True, **d),
             0.0, 512),
        ]
    # the MLA fold's edges on the tensor cores (csrc/paged_mla.cu), bf16 and
    # f32 (3xTF32): a parked row (zeros), unallocated table entries mid-row,
    # pages of 8, 32 and 64, one row of 2048-4096 keys (the most key
    # splits), each at G 128 (the mla_* cases above hold G 16 over 2 rows:
    # one partial group)
    for dtype in (torch.bfloat16, torch.float32):
        mla = dict(hkv=1, g=128, T=1, dk=576, shared_kv=True, dtype=dtype)
        tag = "f32" if dtype == torch.float32 else "bf16"
        cases += [
            (f"mla_tc_parked_{tag}", dict(B=4, ps=16, P=40, offsets=[300, 77, 511, 128],
                                          seed=64, parked=(1,), **mla), 0.0, 512),
            (f"mla_tc_holes_{tag}", dict(B=3, ps=16, P=40, offsets=[400, 130, 600], seed=65,
                                         holes=(2, 5, 6), **mla), 0.0, 512),
            *((f"mla_tc_page{ps}_{tag}", dict(B=3, ps=ps, P=640 // ps,
                                               offsets=[0, ps + 3, 575], seed=66 + ps, **mla),
               0.0, 512) for ps in (8, 32, 64)),
            (f"mla_tc_ctx4096_{tag}", dict(B=2, ps=16, P=256, offsets=[4095, 2047], seed=67,
                                           **mla), 0.0, 512),
            # softcap (MLA passes 0) over rows long enough for the most splits
            (f"mla_tc_softcap5_{tag}", dict(B=2, ps=16, P=256, offsets=[2047, 300], seed=69,
                                            **mla), 5.0, 512),
        ]
    # separate K and V pools at MLA's widths (values the first 512 columns
    # of a 576-wide pool, or a 512-wide one): the tensor-core kernel reads
    # the values from the key pages, so kernel_path sends these to the
    # CUDA-core path in both dtypes (CASE_PATHS), which stays held at 576/512
    mla_pools = dict(B=2, hkv=1, g=16, T=1, dk=576, ps=16, P=40, offsets=[150, 31])
    cases += [
        ("mla_pools_bf16", dict(seed=70, **mla_pools, **bf), 0.0, 512),
        ("mla_pools_v512_bf16", dict(seed=71, dv_store=512, **mla_pools, **bf), 0.0, 512),
        ("mla_pools_f32", dict(seed=72, **mla_pools, dtype=torch.float32), 0.0, 512),
    ]
    # the tensor-core path's zoo edges: dk 192 prefill at pages of 8 and 64,
    # a 12-row fold at dk 64, granite's 768-row fold (6 row groups) with a
    # parked row and aliased first pages, MQA G 48 decode over one row of
    # 4096 keys (the most key splits), qwen2's 128 rows at offsets
    # straddling a page
    cases += [
        ("tc_dk192_page8_bf16", dict(B=3, hkv=4, g=12, T=16, dk=192, ps=8, P=80,
                                     offsets=[0, 13, 600], seed=55, **bf), 0.0, 0),
        ("tc_dk192_page64_bf16", dict(B=3, hkv=4, g=12, T=16, dk=192, ps=64, P=10,
                                      offsets=[0, 70, 600], seed=56, **bf), 0.0, 0),
        ("tc_rows12_bf16", dict(B=4, hkv=8, g=12, T=1, dk=64, ps=16, P=40,
                                offsets=[0, 37, 300, 639], seed=57, **bf), 0.0, 0),
        ("tc_granite768_parked_aliased_bf16", dict(B=4, hkv=1, g=48, T=16, dk=128, ps=16,
                                                   P=40, offsets=[20, 33, 20, 400], seed=58,
                                                   alias=True, parked=(1,), **bf), 0.0, 0),
        ("tc_mqa_g48_ctx4096_bf16", dict(B=1, hkv=1, g=48, T=1, dk=128, ps=16, P=256,
                                         offsets=[4095], seed=59, **bf), 0.0, 0),
        ("tc_qwen2_rows128_straddle_bf16", dict(B=3, hkv=8, g=8, T=16, dk=128, ps=16, P=40,
                                                offsets=[7, 23, 599], seed=60, **bf), 0.0, 0),
    ]
    # the f32 tensor-core route's edges (3xTF32, csrc/paged_tensor_core.cu)
    # at the zoo's shapes: dk 192 prefill at pages of 8 and 64 straddling a
    # page, granite's 768-row fold (6 row groups) with a parked row and
    # aliased first pages, MQA G 48 decode over 2 rows (10 key splits) and
    # over one row of 4096 keys (16), a softcap at nemotron's 12-row decode
    # (2 in-block splits), 144 rows at dk 128 (a second row group cut short
    # to 4 M-tiles), the mixed widths at 64 rows
    f = {"dtype": torch.float32}
    cases += [
        ("tc_dk192_page8_f32", dict(B=3, hkv=4, g=12, T=16, dk=192, ps=8, P=80,
                                    offsets=[0, 13, 600], seed=80, **f), 0.0, 0),
        ("tc_dk192_page64_f32", dict(B=3, hkv=4, g=12, T=16, dk=192, ps=64, P=10,
                                     offsets=[0, 70, 600], seed=81, **f), 0.0, 0),
        ("tc_granite768_parked_aliased_f32", dict(B=4, hkv=1, g=48, T=16, dk=128, ps=16,
                                                  P=40, offsets=[20, 33, 20, 400], seed=82,
                                                  alias=True, parked=(1,), **f), 0.0, 0),
        ("tc_mqa_g48_splits_f32", dict(B=2, hkv=1, g=48, T=1, dk=128, ps=16, P=40,
                                       offsets=[200, 9], seed=83, **f), 0.0, 0),
        ("tc_mqa_g48_ctx4096_f32", dict(B=1, hkv=1, g=48, T=1, dk=128, ps=16, P=256,
                                        offsets=[4095], seed=84, **f), 0.0, 0),
        ("tc_softcap30_dk192_decode_f32", dict(B=3, hkv=8, g=12, T=1, dk=192, ps=16, P=40,
                                               offsets=[0, 48, 600], seed=85, **f), 30.0, 0),
        ("tc_rows144_groups_cut_f32", dict(B=3, hkv=2, g=9, T=16, dk=128, ps=16, P=40,
                                           offsets=[7, 23, 599], seed=86, **f), 0.0, 0),
        ("tc_dk64_dv128_f32", dict(B=3, hkv=4, g=4, T=16, dk=64, dv_store=128, ps=16, P=40,
                                   offsets=[0, 45, 300], seed=87, **f), 0.0, 0),
        ("tc_dk128_dv64_f32", dict(B=3, hkv=4, g=4, T=16, dk=128, dv_store=64, ps=16, P=40,
                                   offsets=[0, 45, 300], seed=88, **f), 0.0, 0),
    ]
    # internvl2-1b's decode: 14 query heads over 2 KV heads, a 7-row fold at
    # dk 64 (under TENSOR_CORE_MIN_ROWS: the decode path), 16 rows of
    # 128-160 keys
    cases += [(f"dec_vlm_g7_{tag}", dict(B=16, hkv=2, g=7, T=1, dk=64, ps=16, P=40,
                                         offsets=list(range(128, 160, 2)), seed=90, dtype=dt),
               0.0, 0) for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))]
    # the parity engine's slots (max_len 128: 8 pages of 16), its own dtype
    cases += [
        ("parity_decode_f32", dict(B=4, hkv=12, g=1, T=1, dk=64, ps=16, P=8,
                                   offsets=[0, 37, 90, 127], seed=12, dtype=torch.float32),
         0.0, 0),
        ("parity_prefill_f32", dict(B=4, hkv=12, g=1, T=16, dk=64, ps=16, P=8,
                                    offsets=[0, 16, 48, 112], seed=13, dtype=torch.float32),
         0.0, 0),
    ]
    return cases


# The path these cases must take (as the wrapper counted its launch);
# every tc_* and mla_tc_* case takes the tensor-core path and every dec_*
# case the decode path
CASE_PATHS = {
    # the zoo's folds in both dtypes (f32 in 3xTF32): G*T 768, 8 M-tiles, dk 192
    **{f"zoo_{at}_{tag}": "tensor_core" for at in ("granite_prefill", "qwen2_prefill",
                                                  "nemotron_decode", "nemotron_prefill")
       for tag in ("f32", "bf16")},
    "verify_g1_T9_f32": "tensor_core", "verify_g1_T9_bf16": "tensor_core",
    "mla_f32": "tensor_core", "mla_bf16": "tensor_core",  # G 16
    **{f"mla_full_{at}_{tag}": "tensor_core" for at in ("decode", "t4") for tag in ("f32", "bf16")},
    # separate pools
    "mla_pools_bf16": "cuda_core", "mla_pools_v512_bf16": "cuda_core", "mla_pools_f32": "cuda_core",
}
# MLA's scores are scaled by 1 / sqrt(nope + rope) = 1 / sqrt(128 + 64), not
# by the 576-wide latent's own width (models/mla.py)
MLA_SCALE = 1.0 / math.sqrt(192)


def check_paged_attention() -> dict:
    from repro_torch.kernels.flash_decode import (
        paged_flash_attention_folded,
        paged_flash_attention_folded_plain,
    )

    worst = {"float32": 0.0, "bfloat16": 0.0}
    for name, kw, softcap, v_width in paged_cases():
        q, kp, vp, table, offs = paged_inputs(**kw)
        T = kw["T"]
        scale = MLA_SCALE if v_width else 1.0 / math.sqrt(kw["dk"])
        before = dict(paged_flash_attention_folded.launches_by_path)
        got = paged_flash_attention_folded(q, kp, vp, table, offs, tokens_per_row=T,
                                           scale=scale, softcap=softcap, v_width=v_width)
        torch.cuda.synchronize()
        took = [p for p, n in paged_flash_attention_folded.launches_by_path.items()
                if n != before[p]]
        require(len(took) == 1, f"paged_attention case {name} counted launches on {took}")
        path = took[0]
        want = paged_flash_attention_folded_plain(q, kp, vp, table, offs, tokens_per_row=T,
                                                  scale=scale, softcap=softcap,
                                                  v_width=v_width)
        err = (got.float() - want.float()).abs().max().item()
        t = tol(kw["dtype"])
        ok = bool(torch.allclose(got.float(), want.float(), atol=t, rtol=t))
        rec = {"phase": "kernels", "kernel": "paged_attention", "case": name,
               "shape": list(q.shape), "page_size": kw["ps"], "path": path,
               "max_abs_err": err, "ok": ok}
        require(not name.startswith("dec_") or path == "decode",
                f"paged_attention case {name} did not take the decode path")
        require(not name.startswith(("tc_", "mla_tc_")) or path == "tensor_core",
                f"paged_attention case {name} did not take the tensor-core path")
        require(CASE_PATHS.get(name, path) == path,
                f"paged_attention case {name} took the {path} path, not {CASE_PATHS.get(name)}")
        if kw.get("parked"):
            zero = bool((got[list(kw["parked"])] == 0).all().item())
            rec["parked_rows_exact_zero"] = zero
            ok = ok and zero
        emit(rec)
        require(ok, f"paged_attention case {name} disagrees with its plain version")
        key = str(kw["dtype"]).removeprefix("torch.")
        worst[key] = max(worst[key], err)
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).removeprefix("torch.")
        worst[key] = max(worst[key], check_cross_cache(dtype))
    return worst


def cross_cache_inputs(dtype, seed: int = 31):
    """whisper-tiny's decode cross attention at the serve shape: B 16 rows,
    Hkv 6 heads of 64 (G 1), a cross cache of 1,500 frames read through
    its page view (``cross_page_view``: pages of 20, offsets 1499):
    ``(q, k_pool, v_pool, table, offsets, caches)``, q folded and
    ``caches`` the contiguous ``(B, 1500, Hkv, hd)`` K and V."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import cross_page_view

    cfg = get_arch(WHISPER_ARCH)
    b, n, hkv, hd = WHISPER_SERVE_KW["max_batch"], cfg.encoder_seq, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kc, vc = (torch.randn((b, n, hkv, hd), generator=gen, device="cuda").to(dtype)
              for _ in "kv")
    ps, table, offsets = cross_page_view(b, n, kc.device)
    q = torch.randn((b, hkv, cfg.n_heads // hkv, hd), generator=gen, device="cuda").to(dtype)
    pool = (b * n // ps, ps, hkv, hd)
    return q, kc.view(pool), vc.view(pool), table, offsets, (kc, vc)


def check_cross_cache(dtype) -> float:
    """The paged kernel over whisper's cross cache (``cross_cache_inputs``)
    against its plain version, on the decode path."""
    from repro_torch.kernels.flash_decode import (
        paged_flash_attention_folded,
        paged_flash_attention_folded_plain,
    )

    q, kp, vp, table, offs, _ = cross_cache_inputs(dtype)
    before = paged_flash_attention_folded.launches_by_path["decode"]
    got = paged_flash_attention_folded(q, kp, vp, table, offs, tokens_per_row=1)
    torch.cuda.synchronize()
    on_decode = paged_flash_attention_folded.launches_by_path["decode"] == before + 1
    want = paged_flash_attention_folded_plain(q, kp, vp, table, offs, tokens_per_row=1,
                                              scale=1.0 / math.sqrt(q.shape[-1]))
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.allclose(got.float(), want.float(), atol=tol(dtype), rtol=tol(dtype)))
    name = f"dec_whisper_cross_{'f32' if dtype == torch.float32 else 'bf16'}"
    emit({"phase": "kernels", "kernel": "paged_attention", "case": name,
          "shape": list(q.shape), "page_size": kp.shape[1], "pages_per_slot": table.shape[1],
          "path": "decode" if on_decode else "other", "max_abs_err": err, "ok": ok})
    require(on_decode, f"paged_attention case {name} did not take the decode path")
    require(ok, f"paged_attention case {name} disagrees with its plain version")
    return err


# compiled into csrc/rmsnorm.cu
RMSNORM_ONE_PASS_WIDTHS = (512, 768, 896, 1536, 2048, 3840, 4096, 5120, 6144, 8192, 18432)


def rmsnorm_path(call):
    """Run ``call``, one RMSNorm launch, and name the path the kernel
    reported for it: ``(output, path)``."""
    from repro_torch.kernels.rmsnorm import rmsnorm

    before = dict(rmsnorm.launches_by_path)
    out = call()
    moved = [p for p, n in rmsnorm.launches_by_path.items() if n != before[p]]
    require(len(moved) == 1, f"rmsnorm: one launch moved the path counts {moved}")
    return out, moved[0]


def check_rmsnorm() -> dict:
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    gen = torch.Generator(device="cuda").manual_seed(11)
    # 4096: zamba2-1.2b's shared block (2 x d_model), compiled into the one-pass path
    cases = [(r, d, dt, dt) for dt in (torch.float32, torch.bfloat16)
             for r in (1, 37, 4096) for d in (64, 768, 3840, 4096)]
    cases += [(37, 100, torch.bfloat16, torch.bfloat16), (37, 100, torch.float32, torch.float32),
              (37, 768, torch.bfloat16, torch.float32)]
    cases += [(37, 768, torch.float32, "misaligned"), (37, 768, torch.bfloat16, "misaligned")]
    # mamba2-1.3b's width: a decode dispatch (16 rows) and a prefill one (16 x 16)
    cases += [(r, 2048, dt, dt) for dt in (torch.float32, torch.bfloat16) for r in (16, 256)]
    # the dense zoo's widths (granite-34b's 6144, qwen2-72b's 8192,
    # nemotron-4-340b's 18432), one pass: 18432 a row of 1,024 threads
    cases += [(37, 8192, torch.float32, torch.float32), (37, 8192, torch.bfloat16, torch.bfloat16),
              (5, 18432, torch.bfloat16, torch.float32), (16, 18432, torch.bfloat16, torch.bfloat16),
              (5, 18432, torch.float32, torch.bfloat16), (37, 18432, torch.float32, torch.float32)]
    cases += [(r, 6144, dt, dt) for dt in (torch.float32, torch.bfloat16) for r in (16, 256)]
    # deepseek-v2-236b's widths, one pass: ln1/ln2/ln_f at 5120, q_norm at
    # 1536, kv_norm at 512; a decode dispatch's 16 rows and 256, and w in
    # the other dtype
    cases += [(r, d, dt, dt) for dt in (torch.float32, torch.bfloat16) for r in (16, 256)
              for d in (5120, 1536, 512)]
    cases += [(37, d, torch.bfloat16, torch.float32) for d in (5120, 1536, 512)]
    cases += [(37, d, torch.float32, torch.bfloat16) for d in (5120, 1536, 512)]
    # internvl2-1b's 896, one pass: a decode dispatch's 16 rows and 256
    cases += [(r, 896, dt, dt) for dt in (torch.float32, torch.bfloat16) for r in (16, 256)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for rows, d, xdt, wdt in cases:
        x = torch.randn((rows, d), generator=gen, device="cuda").to(xdt)
        misaligned = wdt == "misaligned"
        if misaligned:  # rows off the 16-byte grid take the scalar path
            x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(rows, d)
            wdt = xdt
        w = (torch.randn((d,), generator=gen, device="cuda") + 1.0).to(wdt)
        got, path = rmsnorm_path(lambda: rmsnorm(x, w, 1e-5))
        torch.cuda.synchronize()
        want = rmsnorm_plain(x, w, 1e-5)
        err = (got.float() - want.float()).abs().max().item()
        t = tol(xdt)
        ok = bool(torch.allclose(got.float(), want.float(), atol=t, rtol=t))
        emit({"phase": "kernels", "kernel": "rmsnorm", "rows": rows, "d": d,
              "x_dtype": str(xdt), "w_dtype": str(wdt), "misaligned": misaligned,
              "path": path, "max_abs_err": err, "ok": ok})
        require(ok, f"rmsnorm rows={rows} d={d} {xdt} disagrees with its plain version")
        one_pass = d in RMSNORM_ONE_PASS_WIDTHS and not misaligned
        require(path == ("one_pass" if one_pass else "generic"),
                f"rmsnorm rows={rows} d={d} {xdt} misaligned={misaligned} took the {path} path")
        key = str(xdt).removeprefix("torch.")
        worst[key] = max(worst[key], err)
    return worst


def check_rmsnorm_grad() -> float:
    """The autograd wrapper's gradients on the card against autograd
    through the plain version (f32): the kernel's forward must not cut
    the graph."""
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((37, 768), generator=gen, device="cuda")
    w = torch.randn((768,), generator=gen, device="cuda") + 1.0
    g = torch.randn((37, 768), generator=gen, device="cuda")
    grads = []
    for fn in (rmsnorm, rmsnorm_plain):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        fn(xx, ww, 1e-5).backward(g)
        grads.append((xx.grad, ww.grad))
    err = max((a - b).abs().max().item() for a, b in zip(grads[0], grads[1]))
    ok = all(torch.allclose(a, b, atol=1e-4, rtol=1e-4) for a, b in zip(grads[0], grads[1]))
    emit({"phase": "kernels", "kernel": "rmsnorm", "case": "grad_f32", "max_abs_err": err,
          "ok": ok})
    require(ok, "rmsnorm's gradient on the card disagrees with autograd of its plain version")
    return err


def flash_cases():
    """(name, bh, s, hd, block, causal, window, dtype): the reference's sweep
    (tests/test_kernels.py::test_flash_attention_sweep), its sliding-window
    cases and the eval phase's timed shapes."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for bh, s, hd, block in ((2, 128, 64, 64), (1, 256, 128, 128), (3, 512, 64, 256),
                                 (2, 128, 192, 64)):
            for causal in (True, False):
                cases.append((f"sweep_{bh}x{s}x{hd}_b{block}_{'causal' if causal else 'full'}"
                              f"_{tag}", bh, s, hd, block, causal, 0, dtype))
        for window in (32, 128):
            cases.append((f"window{window}_{tag}", 2, 256, 64, 64, True, window, dtype))
    # the eval phase's shapes and each kernel's edges, in both dtypes: a
    # ragged last block of 128 rows (bf16 and f32 at hd 64), windows at S
    # 320, head widths 128 and 192 (wgmma: two and three 64-column slabs;
    # 3xTF32: one M-tile a warp, 64-row blocks, Q split as it is read), and
    # from 1024 queries on bf16 hd 64's 192-row blocks (three warpgroups): a
    # ragged last block of 64 rows, a window
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        cases.append((f"eval_8x512_{tag}", 96, 512, 64, 512, True, 0, dtype))
        cases.append((f"eval_2x4096_{tag}", 24, 4096, 64, 512, True, 0, dtype))
        for s, causal in ((192, True), (192, False), (320, True), (320, False)):
            cases.append((f"ragged_s{s}_{'causal' if causal else 'full'}_{tag}", 3, s, 64, 64,
                          causal, 0, dtype))
        for window in (32, 128):
            cases.append((f"window{window}_s320_{tag}", 2, 320, 64, 64, True, window, dtype))
        for hd in (128, 192):
            for causal in (True, False):
                cases.append((f"hd{hd}_s320_{'causal' if causal else 'full'}_{tag}", 2, 320, hd,
                              64, causal, 0, dtype))
        for causal in (True, False):
            cases.append((f"rows192_s1216_{'causal' if causal else 'full'}_{tag}", 2, 1216, 64,
                          64, causal, 0, dtype))
        cases.append((f"rows192_window128_s1216_{tag}", 2, 1216, 64, 64, True, 128, dtype))
        # mixtral's eval: hd 128, a 4096 window over 8192 positions (tiles
        # wholly below the window skipped), at a small BH for the plain
        # version's (BH, S, S) scores
        cases.append((f"mixtral_hd128_window4096_s8192_{tag}", 2, 8192, 128, 512, True,
                      MOE_WINDOW, dtype))
        # h2o-danube-3-4b's head width 120, run at a padded depth of 128:
        # causal at BH 32 x 512, ragged S 320 causal and not, a window
        # crossed at S 1216 with a ragged last tile, and the eval's 4096
        # window over 8192 positions at a small BH
        cases.append((f"hd120_causal_32x512_{tag}", 32, 512, 120, 512, True, 0, dtype))
        for causal in (True, False):
            cases.append((f"hd120_s320_{'causal' if causal else 'full'}_{tag}", 2, 320, 120, 64,
                          causal, 0, dtype))
        cases.append((f"hd120_window128_s1216_{tag}", 2, 1216, 120, 64, True, 128, dtype))
        cases.append((f"danube_hd120_window4096_s8192_{tag}", 2, 8192, 120, 512, True,
                      DANUBE_WINDOW, dtype))
        # whisper-tiny's encoder: non-causal over 1,500 frames (23 tiles of
        # 64 and 28 rows), at blocks equal to the length as the model passes
        # them; lengths that are no multiple of 16, causal and not (a last
        # key tile ending inside a 16-key k-step, a last query block ending
        # inside a warpgroup's 16-row slice)
        cases.append((f"whisper_full_s1500_{tag}", 2, 1500, 64, 1500, False, 0, dtype))
        for s in (100, 1436):
            for causal in (True, False):
                cases.append((f"ragged16_s{s}_{'causal' if causal else 'full'}_{tag}", 2, s, 64,
                              s, causal, 0, dtype))
    return cases


# (name, bh, sq, skv, hd, causal, block_q, block_k): queries and keys of
# different lengths (positions count from 0 in both); whisper's cross
# attention, 448 decoder queries over 1,500 frames, at blocks equal to the
# lengths
FLASH_SQ_NE_SKV = [(f"sq{sq}_skv{skv}", 2, sq, skv, 64, causal, 64, 64)
                   for sq, skv in ((128, 320), (320, 192), (1216, 1024))
                   for causal in (True, False)] + [
    ("whisper_cross_sq448_skv1500", 2, 448, 1500, 64, False, 448, 1500)]


def check_flash_attention() -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_bhsd,
        flash_attention_bhsd_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for name, bh, s, hd, block, causal, window, dtype in flash_cases():
        q, k, v = (torch.randn((bh, s, hd), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        got = flash_attention_bhsd(q, k, v, causal=causal, window=window, block_q=block,
                                   block_k=block)
        torch.cuda.synchronize()
        want = flash_attention_bhsd_plain(q, k, v, causal=causal, window=window)
        err = (got.float() - want.float()).abs().max().item()
        t = tol(dtype)
        ok = bool(torch.allclose(got.float(), want.float(), atol=t, rtol=t))
        emit({"phase": "kernels", "kernel": "flash_attention", "case": name,
              "shape": [bh, s, hd], "max_abs_err": err, "ok": ok})
        require(ok, f"flash_attention case {name} disagrees with its plain version")
        key = str(dtype).removeprefix("torch.")
        worst[key] = max(worst[key], err)
    for name, bh, sq, skv, hd, causal, block_q, block_k in FLASH_SQ_NE_SKV:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((bh, sq, hd), generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn((bh, skv, hd), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            got = flash_attention_bhsd(q, k, v, causal=causal, block_q=block_q, block_k=block_k)
            torch.cuda.synchronize()
            want = flash_attention_bhsd_plain(q, k, v, causal=causal)
            err = (got.float() - want.float()).abs().max().item()
            ok = bool(torch.allclose(got.float(), want.float(), atol=tol(dtype), rtol=tol(dtype)))
            case = (f"{name}_{'causal' if causal else 'full'}_"
                    f"{'f32' if dtype == torch.float32 else 'bf16'}")
            emit({"phase": "kernels", "kernel": "flash_attention", "case": case,
                  "shape": [bh, sq, skv, hd], "max_abs_err": err, "ok": ok})
            require(ok, f"flash_attention case {case} disagrees with its plain version")
            key = str(dtype).removeprefix("torch.")
            worst[key] = max(worst[key], err)
    # operands at an offset off the 16-byte grid (the wrapper copies them)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(2 * 128 * 64 + 1, generator=gen, device="cuda").to(dtype)[1:]
                   .view(2, 128, 64) for _ in range(3))
        got = flash_attention_bhsd(q, k, v, causal=True)
        torch.cuda.synchronize()
        want = flash_attention_bhsd_plain(q, k, v, causal=True)
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol(dtype), rtol=tol(dtype)))
        name = f"misaligned_{'f32' if dtype == torch.float32 else 'bf16'}"
        emit({"phase": "kernels", "kernel": "flash_attention", "case": name,
              "shape": [2, 128, 64], "max_abs_err": err, "ok": ok})
        require(ok, f"flash_attention case {name} disagrees with its plain version")
    # the model layout: (B, S, H, hd) folded to (B*H, S, hd) and back
    q, k, v = (torch.randn((2, 128, 4, 64), generator=gen, device="cuda") for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    torch.cuda.synchronize()
    want = ref.ORACLES["flash_attention"](q, k, v, causal=True)
    err = (got - want).abs().max().item()
    ok = bool(torch.allclose(got, want, atol=F32_TOL, rtol=F32_TOL))
    emit({"phase": "kernels", "kernel": "flash_attention", "case": "model_layout_f32",
          "shape": list(q.shape), "max_abs_err": err, "ok": ok})
    require(ok, "flash_attention in the model layout disagrees with its oracle")
    worst["float32"] = max(worst["float32"], err)
    return worst


def ssd_inputs(b, nc, q, h, p, n, dtype, seed, lengths=None):
    """Random SSD chunk inputs on the card with the reference sweep's
    distributions (x, B, C ~ N(0, 1) in ``dtype``; dt = softplus(N(0, 1))
    and A = -exp(N(0, 1) / 2) in f32).  ``lengths`` gives each batch row's
    valid positions (one chunk): later ones get dt = 0, as the padded
    tokens of a prefill dispatch do.  Returns ``(x, dt, A, B, C)``."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, nc, q, h, p), generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn((b, nc, q, h), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda") * 0.5)
    B = torch.randn((b, nc, q, n), generator=gen, device="cuda").to(dtype)
    C = torch.randn((b, nc, q, n), generator=gen, device="cuda").to(dtype)
    if lengths is not None:
        valid = torch.arange(q, device="cuda")[None, :] < torch.as_tensor(lengths, device="cuda")[:, None]
        dt = dt * valid[:, None, :, None]
    return x, dt, A, B, C


def ssd_cases():
    """(name, (b, nc, q, h, p, n), block_h, dtype, lengths): the reference's
    sweep (tests/test_kernels.py::test_ssd_kernel_sweep), short chunks
    (serving prefill picks divisors of prefill_chunk), the serve prefill
    shape with padded tokens and idle rows, and the eval shapes of
    mamba2-1.3b (8 x 512, 2 x 4096)."""
    serve_lengths = [16, 0, 5, 16, 1, 0, 9, 16, 16, 3, 16, 0, 12, 16, 7, 16]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for b, l, h, p, n, chunk, bh in ((2, 64, 4, 16, 16, 16, 2), (1, 128, 8, 32, 32, 32, 4),
                                         (2, 256, 16, 64, 128, 128, 8)):
            cases.append((f"sweep_{b}x{l}_h{h}_p{p}_n{n}_q{chunk}_{tag}",
                          (b, l // chunk, chunk, h, p, n), bh, dtype, None))
        for q in (1, 2, 4, 7, 16):
            cases.append((f"q{q}_{tag}", (2, 3, q, 16, 64, 128), 8, dtype, None))
        cases.append((f"serve_prefill_padded_{tag}", (16, 1, 16, 64, 64, 128), 8, dtype,
                       serve_lengths))
        cases.append((f"eval_8x512_{tag}", (8, 4, 128, 64, 64, 128), 8, dtype, None))
        cases.append((f"eval_2x4096_{tag}", (2, 32, 128, 64, 64, 128), 8, dtype, None))
        # zamba2-1.2b's state width, n 64: serve prefill and the eval shapes
        cases.append((f"zamba2_serve_prefill_padded_{tag}", (16, 1, 16, 64, 64, 64), 8, dtype,
                      serve_lengths))
        cases.append((f"zamba2_eval_8x512_{tag}", (8, 4, 128, 64, 64, 64), 8, dtype, None))
        cases.append((f"zamba2_eval_2x4096_{tag}", (2, 32, 128, 64, 64, 64), 8, dtype, None))
    return cases


# The kernel and its plain version take the same running sums and differ
# only in summation order: 2e-5 (f32) holds for Y_diag and the states.
# ops.ssd adds the inter-chunk scan, where a state carried over many
# chunks sums the per-chunk rounding differences: its final state is held
# at 1e-4 (the reference's own test holds it at 1e-3).
SSD_STATE_TOL = 1e-4
# bf16 takes its products on the tensor cores with M and w x in three bf16
# parts (about 2^-24 of each), so it sits ~1e-5 from its plain version:
# held at 1e-4 beside BF16_TOL.  The plain outputs rounded to bf16 hold
# 2e-2 but miss 1e-4 some 35x; on the eval cases the kernel's own outputs
# so rounded must miss it, or the tight check is blind.
SSD_BF16_TOL = 1e-4
SSD_BF16_CONTROL_CASES = ("eval_8x512_bf16", "eval_2x4096_bf16")


def ssd_tol(dtype) -> float:
    """The tolerance the SSD kernel is held to against its plain version."""
    return SSD_BF16_TOL if dtype == torch.bfloat16 else F32_TOL


def check_ssd() -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ssd import ssd_chunk, ssd_chunk_plain

    worst = {"float32": 0.0, "bfloat16": 0.0}
    for seed, (name, (b, nc, q, h, p, n), bh, dtype, lengths) in enumerate(ssd_cases()):
        x, dt, A, B, C = ssd_inputs(b, nc, q, h, p, n, dtype, 40 + seed, lengths)
        dA = dt * A
        y, st = ssd_chunk(x, dA, dt, B, C, block_h=bh)
        torch.cuda.synchronize()
        y_want, st_want = ssd_chunk_plain(x, dA, dt, B, C)
        err = max((y - y_want).abs().max().item(), (st - st_want).abs().max().item())
        t = ssd_tol(dtype)  # bf16's 1e-4 holds BF16_TOL's 2e-2 too
        ok = bool(torch.allclose(y, y_want, atol=t, rtol=t)
                  and torch.allclose(st, st_want, atol=t, rtol=t))
        rec = {"phase": "kernels", "kernel": "ssd", "case": name,
               "shape": {"b": b, "nc": nc, "q": q, "h": h, "p": p, "n": n, "block_h": bh},
               "max_abs_err": err, "tol": tol(dtype), "ok": ok}
        if dtype == torch.bfloat16:
            rec["ssd_bf16_tol"] = SSD_BF16_TOL
            rec["worst_over_ssd_bf16_tol"] = max(worst_over(y, y_want, SSD_BF16_TOL),
                                                 worst_over(st, st_want, SSD_BF16_TOL))
        if name in SSD_BF16_CONTROL_CASES:
            rounded = max(worst_over(y.bfloat16().float(), y_want, SSD_BF16_TOL),
                          worst_over(st.bfloat16().float(), st_want, SSD_BF16_TOL))
            rec["control_outputs_rounded_to_bf16_worst_over_ssd_bf16_tol"] = rounded
            require(rounded > 1, f"ssd case {name}: the kernel's outputs rounded to bf16 hold "
                                 f"{SSD_BF16_TOL}, so the check cannot tell them apart")
        if lengths is not None:
            idle = [r for r, length in enumerate(lengths) if length == 0]
            zero = bool((y[idle] == 0).all().item() and (st[idle] == 0).all().item())
            rec["idle_rows_exact_zero"] = zero
            ok = ok and zero
        emit(rec)
        require(ok, f"ssd case {name} disagrees with its plain version")
        key = str(dtype).removeprefix("torch.")
        worst[key] = max(worst[key], err)
    # the model-layout op: kernel + inter-chunk glue from a carried state,
    # against the model's plain chunked scan
    gen = torch.Generator(device="cuda").manual_seed(60)
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, A, B, C = ssd_inputs(2, 4, 64, 16, 64, 128, dtype, 61)
        x, dt = x.reshape(2, 256, 16, 64), dt.reshape(2, 256, 16)
        B, C = B.reshape(2, 256, 128), C.reshape(2, 256, 128)
        init = torch.randn((2, 16, 64, 128), generator=gen, device="cuda")
        y, final = ops.ssd(x, dt, A, B, C, chunk=64, initial_state=init)
        torch.cuda.synchronize()
        y_want, final_want = ref.ORACLES["ssd"](x, dt, A, B, C, 64, initial_state=init)
        t = tol(dtype)
        y_err = (y.float() - y_want.float()).abs().max().item()
        st_err = (final - final_want).abs().max().item()
        ok = bool(torch.allclose(y.float(), y_want.float(), atol=t, rtol=t)
                  and torch.allclose(final, final_want, atol=SSD_STATE_TOL, rtol=SSD_STATE_TOL))
        name = f"ops_initial_state_{'f32' if dtype == torch.float32 else 'bf16'}"
        emit({"phase": "kernels", "kernel": "ssd", "case": name, "shape": list(x.shape),
              "chunk": 64, "max_abs_err": y_err, "final_state_max_abs_err": st_err,
              "final_state_tol": SSD_STATE_TOL, "ok": ok})
        require(ok, f"ssd case {name} disagrees with the model's chunked scan")
        key = str(dtype).removeprefix("torch.")
        worst[key] = max(worst[key], y_err)
    return worst


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {"paged_attention": check_paged_attention(), "rmsnorm": check_rmsnorm(),
            "flash_attention": check_flash_attention(), "ssd": check_ssd()}
    errs["rmsnorm"]["grad_float32"] = check_rmsnorm_grad()
    rec = {"phase": "kernels", "max_abs_err": errs,
           "launches_in_checks": read_launches()}
    emit(rec)
    return rec


# ------------------------------------------------------------------ parity
NEAR_TIE_GAP = 1e-3


def parity_requests(vocab: int, max_new_tokens: int = 24):
    """6 greedy requests, ragged prompts of 5-70 tokens, ``max_new_tokens``
    new each; p0 and p5 share a 40-token prefix (p5 is admitted after p0
    published it)."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(1)
    prefix = rng.integers(1, vocab, 40).tolist()
    tails = {0: 8, 5: 4}
    lengths = [48, 70, 23, 5, 61, 44]
    prompts = []
    for i, n in enumerate(lengths):
        if i in tails:
            prompts.append(prefix + rng.integers(1, vocab, tails[i]).tolist())
        else:
            prompts.append(rng.integers(1, vocab, n).tolist())
    return [Request(uid=f"p{i}", prompt=p, max_new_tokens=max_new_tokens)
            for i, p in enumerate(prompts)]


def next_token_logits(model, params, tokens, device) -> torch.Tensor:
    """Logits after ``tokens`` from a fresh one-row cache (paged where the
    architecture pages, dense otherwise)."""
    ps = 16
    pages = -(-(len(tokens) + 1) // ps)
    if model.supports_paged_cache:
        cache = model.init_cache(1, pages * ps, paged=True, page_size=ps, n_pages=pages,
                                 device=device)
        cache["page_table"].copy_(torch.arange(pages, dtype=torch.int32)[None])
    else:
        cache = model.init_cache(1, pages * ps, device=device)
    if model.cfg.is_encoder_decoder:  # no fused prefill: a token a decode step
        for i, t in enumerate(tokens):
            logits, _ = model.decode_step(params, cache, torch.tensor([[t]], device=device),
                                          torch.tensor([i], device=device))
        return logits[0, 0, :model.cfg.vocab_size].float()
    logits = None
    for s in range(0, len(tokens), ps):
        chunk = tokens[s:s + ps]
        tok = torch.tensor([chunk], dtype=torch.long, device=device)
        logits, _ = model.prefill_chunk(
            params, cache, tok, torch.tensor([s], device=device),
            torch.tensor([len(chunk)], device=device))
    return logits[0, :model.cfg.vocab_size].float()


def run_engine(model, params, reqs, device, **kw):
    from repro_torch.serving.engine import ServeEngine

    eng = ServeEngine(model, params, device=device, **kw)
    eng.submit(reqs)
    t0 = time.perf_counter()
    eng.run_to_completion()
    if device == "cuda":
        torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def launch_counters() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.flash_decode import paged_flash_attention_folded
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd import ssd_chunk

    return {"paged_attention": paged_flash_attention_folded, "rmsnorm": rmsnorm,
            "flash_attention": flash_attention_bhsd, "ssd": ssd_chunk}


# the kernels whose launches are also counted per path
PATHED = ("paged_attention", "rmsnorm")


def reset_launches():
    from repro_torch.kernels import flash_decode
    from repro_torch.kernels import rmsnorm as rmsnorm_mod

    for fn in launch_counters().values():
        fn.launches = 0
    paged = flash_decode.paged_flash_attention_folded
    paged.launches_by_path = dict.fromkeys(flash_decode.PATHS, 0)
    rmsnorm_mod.rmsnorm.launches_by_path = dict.fromkeys(rmsnorm_mod.PATHS, 0)


def read_launches() -> dict:
    """Launches per kernel, the paged kernel's per path
    (``paged_attention_cuda_core``, ``paged_attention_tensor_core``,
    ``paged_attention_decode``) and RMSNorm's (``rmsnorm_one_pass``,
    ``rmsnorm_generic``)."""
    counters = launch_counters()
    counts = {name: fn.launches for name, fn in counters.items()}
    for name in PATHED:
        for path, n in counters[name].launches_by_path.items():
            counts[f"{name}_{path}"] = n
    return counts


PARITY_COUNTERS = ("dispatches", "prefill_dispatches", "decode_dispatches", "tokens_emitted",
                   "prefix_hit_tokens", "peak_pages")


def divergences(model, params_cpu, a, b, what: str, device: str = "cpu") -> list:
    """The first differing token of each request two engine runs finished
    (their finished requests and output lengths must be equal) and the
    CPU's top-2 logit gap after ``b``'s prefix there (``device``'s, with
    ``params_cpu`` on it, where no CPU copy of the weights is held)."""
    got = {r.uid: r.output for r in a.finished}
    want = {r.uid: r.output for r in b.finished}
    require(sorted(got) == sorted(want), f"{what}: the runs finished different requests")
    prompts = {r.uid: r.prompt for r in b.finished}
    out = []
    for uid in sorted(want):
        x, y = got[uid], want[uid]
        require(len(x) == len(y), f"{what}: {uid}: output lengths differ")
        k = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v), None)
        if k is None:
            continue
        lg = next_token_logits(model, params_cpu, prompts[uid] + y[:k], device)
        top2 = torch.topk(lg, 2).values
        out.append({"uid": uid, "index": k, "cpu_top2_gap": float(top2[0] - top2[1])})
    return out


def compare_greedy(model, params_cpu, gpu, cpu, what: str, device: str = "cpu") -> list:
    """Require equal finished requests and greedy outputs of two engine
    runs, a near-tie at the first difference (a CPU top-2 logit gap below
    ``NEAR_TIE_GAP``; ``device``'s gap, see ``divergences``) being the one
    allowed exception; the divergences."""
    divs = divergences(model, params_cpu, gpu, cpu, what, device)
    for d in divs:
        require(d["cpu_top2_gap"] < NEAR_TIE_GAP,
                f"{what}: {d['uid']}: the runs diverge at token {d['index']} with a CPU "
                f"top-2 gap of {d['cpu_top2_gap']}")
    return divs


def compare_counters(a, b, what: str, names=PARITY_COUNTERS) -> dict:
    counters = {c: [getattr(a, c), getattr(b, c)] for c in names}
    for c, (g, h) in counters.items():
        require(g == h, f"{what}: counter {c} differs: {g} against {h}")
    return counters


def phase_parity() -> tuple:
    """Full-width ds-paper-100m in f32, card against CPU, in paged mode
    (paged kernel, RMSNorm) and in dense mode (RMSNorm, plain attention
    over the per-slot cache), and dense against paged on the card.
    Returns the record and the card's engines by mode."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_decode import PATHS
    from repro_torch.models import Model, ModelRuntime

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity: full-precision matmuls
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch("ds-paper-100m")
    model = Model(cfg, ModelRuntime(dtype=torch.float32))
    base = dict(max_batch=4, max_len=128, prefill_chunk=16)
    modes = {"paged": dict(base, page_size=16, cache_mode="paged"),
             "dense": dict(base, cache_mode="dense")}
    params_gpu = init_params(model, 0, "cuda")
    params_cpu = init_params(model, 0, "cpu")
    rec = {"phase": "parity", "arch": cfg.name, "dtype": "float32", "modes": {}}
    card = {}
    for mode, kw in modes.items():
        reset_launches()
        gpu, gpu_s = run_engine(model, params_gpu, parity_requests(cfg.vocab_size), "cuda", **kw)
        launches = read_launches()
        cpu, cpu_s = run_engine(model, params_cpu, parity_requests(cfg.vocab_size), "cpu", **kw)
        divergences = compare_greedy(model, params_cpu, gpu, cpu, f"parity {mode}")
        counters = compare_counters(gpu, cpu, f"parity {mode}, card against CPU")
        d = gpu.dispatches
        want_paged = cfg.n_layers * d if mode == "paged" else 0
        require(launches["paged_attention"] == want_paged,
                f"{mode}: paged attention launched {launches['paged_attention']} times for "
                f"{d} dispatches")
        require(launches["rmsnorm"] == (2 * cfg.n_layers + 1) * d,
                f"{mode}: rmsnorm launched {launches['rmsnorm']} times for {d} dispatches")
        # f32 decode dispatches (G*T 1) run the split-KV decode path, f32
        # prefill (G*T 16) the tensor-core one in 3xTF32
        want = dict.fromkeys(PATHS, 0)
        if mode == "paged":
            want["decode"] += cfg.n_layers * gpu.decode_dispatches
            want["tensor_core"] += cfg.n_layers * gpu.prefill_dispatches
        got = {p: launches[f"paged_attention_{p}"] for p in PATHS}
        require(got == want, f"{mode}: paged launches by path {got}, want {want} (12 a "
                             f"dispatch: {gpu.decode_dispatches} decode, "
                             f"{gpu.prefill_dispatches} prefill)")
        if mode == "paged":
            require(gpu.prefix_hit_tokens > 0, "the shared prefix was never hit")
        card[mode] = gpu
        rec["modes"][mode] = {
            "tokens_equal": not divergences, "divergences": divergences,
            "counters_card_cpu": counters, "launches": launches,
            "launches_per_dispatch": {k: v / d for k, v in launches.items()},
            "card_s": gpu_s, "cpu_s": cpu_s}
    rec["dense_vs_paged_divergences"] = compare_greedy(
        model, params_cpu, card["dense"], card["paged"], "parity, dense against paged")
    emit(rec)
    return rec, card


# ------------------------------------------------------------------ serve
def serve_requests(vocab: int):
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(2)
    return [Request(uid=f"s{i}", prompt=rng.integers(1, vocab, int(n)).tolist(),
                    max_new_tokens=64)
            for i, n in enumerate(rng.integers(128, 513, 32))]


class DispatchTimer:
    """Wraps an engine dispatch callable; records CUDA events around each
    call (the device time between the dispatch's first and last queued
    work, host gaps included)."""

    def __init__(self, fn):
        self.fn, self.events = fn, []

    def __call__(self, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def summary(xs):
    xs = sorted(xs)
    if not xs:
        return {"n": 0}
    return {"n": len(xs), "median": xs[(len(xs) - 1) // 2],
            "p99": xs[(99 * len(xs) - 1) // 100], "mean": sum(xs) / len(xs)}


def time_ms(fn, iters: int = 30) -> float:
    """Median device time of one call.  Each call runs behind a 64 MiB
    write that evicts the 50 MB L2 (the main path finds a layer's pages
    cold) and a ~1 ms device spin, so the host has queued the whole call
    before its start event fires and host launch overhead is not timed."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in pairs)[iters // 2]


def paged_work(q, kp, table, offs, T, dv, shared_kv: bool = False):
    """Bytes the paged-attention call must move and the flops it must do
    for these inputs: q and out once, plus every attended K/V page once (a
    page that holds both, MLA's latent, once: its ``dk`` columns); scores
    and values over the keys each query may see."""
    b, hkv, ql, dk = q.shape
    n_pages, ps = kp.shape[0], kp.shape[1]
    item = q.element_size()
    tab, off = table.cpu().tolist(), offs.cpu().tolist()
    pages = 0
    flops = 0
    for r in range(b):
        last = off[r] + T - 1
        pages += sum(1 for j, pid in enumerate(tab[r]) if j * ps <= last and 0 <= pid < n_pages)
        keys = sum(off[r] + (i % T) + 1 for i in range(ql))
        flops += 2 * (dk + dv) * keys * hkv
    page_cols = dk if shared_kv else dk + dv
    nbytes = (q.numel() + b * hkv * ql * dv) * item + pages * ps * hkv * page_cols * item
    nbytes += table.numel() * 4 + offs.numel() * 4
    return nbytes, flops


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_at_shape(what: str, kern, plain, dtype) -> float:
    """Hold a kernel against its plain version on the timed inputs; the
    max abs error, or a failed check."""
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    err = (got.float() - want.float()).abs().max().item()
    t = tol(dtype)
    require(bool(torch.allclose(got.float(), want.float(), atol=t, rtol=t)),
            f"{what} disagrees with its plain version at the serve shape (max err {err})")
    return err


def on_path(path: str, fn):
    """``fn`` with the paged kernel's path forced to ``path`` (through
    ``flash_decode.kernel_path``) for the length of each call."""
    from repro_torch.kernels import flash_decode

    def forced():
        real = flash_decode.kernel_path
        flash_decode.kernel_path = lambda *_a, **_k: path
        try:
            return fn()
        finally:
            flash_decode.kernel_path = real
    return forced


def paged_route_bound(nbytes, flops, dtype, path) -> tuple:
    """``(bound_ms, bound_by, bytes_ms)`` of a paged call on its route: its
    bytes over the memory rate against its operations in fp32 outside the
    tensor cores on the CUDA-core path, as three TF32 passes on the f32
    tensor-core route, else at the dtype's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if path == "cuda_core":
        t_ops = flops / PEAK_OPS[torch.float32] * 1e3
    elif path == "tensor_core" and dtype == torch.float32:
        t_ops = 3 * flops / TF32_OPS * 1e3
    else:
        t_ops = flops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_bytes


def time_paged(label, B, T, offsets, dtype, P=40, hkv=12, g=1, dk=64, cuda_core=False):
    """The paged kernel at ``B`` rows of ``T`` tokens, ``hkv`` KV heads of
    ``g`` query heads each (the fold ``G*T``) and head width ``dk``: held
    against its plain version and timed beside its route's bound, its
    plain version and SDPA; with ``cuda_core``, also forced onto the
    CUDA-core path (path code 0 through the C entry) beside that route's
    bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import (
        kernel_path,
        paged_flash_attention_folded,
        paged_flash_attention_folded_plain,
    )

    ps = 16
    q, kp, vp, table, offs = paged_inputs(B=B, hkv=hkv, g=g, T=T, dk=dk, ps=ps, P=P,
                                          offsets=offsets, dtype=dtype, seed=21)
    scale = 1.0 / math.sqrt(dk)
    kern = lambda: paged_flash_attention_folded(  # noqa: E731
        q, kp, vp, table, offs, tokens_per_row=T, scale=scale)
    plain = lambda: paged_flash_attention_folded_plain(  # noqa: E731
        q, kp, vp, table, offs, tokens_per_row=T, scale=scale)
    # yardstick: SDPA on K/V pre-gathered to a contiguous (B, H, P*ps, dk)
    # cache with a boolean mask (the gather is not timed)
    safe = table.long().clamp(max=kp.shape[0] - 1)
    kc = kp[safe].reshape(B, P * ps, hkv, dk).transpose(1, 2).contiguous()
    vc = vp[safe].reshape(B, P * ps, hkv, dk).transpose(1, 2).contiguous()
    q_pos = offs.long()[:, None] + torch.arange(g * T, device="cuda")[None] % T  # the fold
    alloc = torch.repeat_interleave(table < kp.shape[0], ps, dim=1)
    mask = ((torch.arange(P * ps, device="cuda")[None, None] <= q_pos[..., None])
            & alloc[:, None])[:, None]
    lib = lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)  # noqa: E731
    path = kernel_path(dtype, g * T, dk, dk)
    nbytes, flops = paged_work(q, kp, table, offs, T, dk)
    bms, by, _ = paged_route_bound(nbytes, flops, dtype, path)
    err = check_at_shape(f"paged attention ({label})", kern, plain, dtype)
    rec = {"at": label, "shape": {"B": B, "Hkv": hkv, "G": g, "T": T, "dk": dk,
                                  "page_size": ps, "pages_per_slot": P},
           "path": path, "max_abs_err": err, "ms": time_ms(kern)}
    if cuda_core:
        forced = on_path("cuda_core", kern)
        rec["cuda_core_max_abs_err"] = check_at_shape(
            f"paged attention ({label}, CUDA-core path)", forced, plain, dtype)
        rec["cuda_core_ms"] = time_ms(forced)
        rec["bound_ms_cuda_core"] = paged_route_bound(nbytes, flops, dtype, "cuda_core")[0]
    return {**rec, "plain_ms": time_ms(plain), "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lib),
            "library_call": "F.scaled_dot_product_attention on pre-gathered contiguous K/V"}


def time_paged_mla(label, T, offsets, dtype) -> dict:
    """The paged kernel at deepseek-v2-236b's MLA fold (one latent pool
    passed as K and V, Hkv 1, G 128, dk 576, values from the first 512
    columns, MLA's scale), 16 rows of ``T`` tokens: held against its plain
    version and timed beside its bound (bytes: each attended latent page
    once; operations on the tensor cores, bf16 at its peak and f32 as three
    TF32 passes, as the f32 flash kernel's, and on the CUDA cores), its
    plain version and SDPA on K/V pre-gathered to q width 576 and v width
    512; also forced onto the CUDA-core path (path code 0 through the C
    entry), the route each dtype took before the tensor-core kernel of
    csrc/paged_mla.cu."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import (
        kernel_path,
        paged_flash_attention_folded,
        paged_flash_attention_folded_plain,
    )

    B, g, dk, dv, ps, P = len(offsets), 128, 576, 512, 16, 40
    q, kv, _, table, offs = paged_inputs(B=B, hkv=1, g=g, T=T, dk=dk, ps=ps, P=P,
                                         offsets=offsets, dtype=dtype, seed=23, shared_kv=True)
    call = dict(tokens_per_row=T, scale=MLA_SCALE, v_width=dv)
    kern = lambda: paged_flash_attention_folded(q, kv, kv, table, offs, **call)  # noqa: E731
    plain = lambda: paged_flash_attention_folded_plain(  # noqa: E731
        q, kv, kv, table, offs, **call)
    safe = table.long().clamp(max=kv.shape[0] - 1)
    kc = kv[safe].reshape(B, 1, P * ps, dk).contiguous()
    vc = kc[..., :dv].contiguous()
    q_pos = offs.long()[:, None] + torch.arange(g * T, device="cuda")[None] % T  # the fold
    alloc = torch.repeat_interleave(table < kv.shape[0], ps, dim=1)
    mask = ((torch.arange(P * ps, device="cuda")[None, None] <= q_pos[..., None])
            & alloc[:, None])[:, None]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, kc, vc, attn_mask=mask, scale=MLA_SCALE)
    nbytes, flops = paged_work(q, kv, table, offs, T, dv, shared_kv=True)
    path = kernel_path(dtype, g * T, dk, dv)
    bms, by, _ = paged_route_bound(nbytes, flops, dtype, path)
    err = check_at_shape(f"paged attention (MLA {label})", kern, plain, dtype)
    on_cuda_cores = on_path("cuda_core", kern)
    forced = {"cuda_core_max_abs_err": check_at_shape(
                  f"paged attention (MLA {label}, CUDA-core path)", on_cuda_cores, plain, dtype),
              "cuda_core_ms": time_ms(on_cuda_cores)}
    return {"at": f"mla_{label}", "shape": {"B": B, "Hkv": 1, "G": g, "T": T, "dk": dk,
                                            "dv": dv, "page_size": ps, "pages_per_slot": P},
            "path": path, "max_abs_err": err, "keys_per_row": [o + T for o in offsets],
            "ms": time_ms(kern), **forced, "plain_ms": time_ms(plain), "bound_ms": bms,
            "bound_by": by,
            "bound_ms_cuda_core": paged_route_bound(nbytes, flops, dtype, "cuda_core")[0],
            "bound_ms_tensor_core": bms,
            "bytes": nbytes, "flops": flops, "library_ms": time_ms(lib),
            "library_call": "F.scaled_dot_product_attention on pre-gathered K/V (q and k "
                            "width 576, v width 512)"}


def time_rmsnorm(label, rows, d, dtype):
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    gen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((d,), generator=gen, device="cuda") + 1.0).to(dtype)
    nbytes = 2 * rows * d * x.element_size() + d * w.element_size()
    bms, by = bound(nbytes, 4 * rows * d, dtype)
    err = check_at_shape(f"rmsnorm ({label})", lambda: rmsnorm(x, w, 1e-5),
                         lambda: rmsnorm_plain(x, w, 1e-5), dtype)
    return {"at": label, "shape": {"rows": rows, "d": d},
            "path": rmsnorm_path(lambda: rmsnorm(x, w, 1e-5))[1],
            "max_abs_err": err, "ms": time_ms(lambda: rmsnorm(x, w, 1e-5)),
            "plain_ms": time_ms(lambda: rmsnorm_plain(x, w, 1e-5)),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, 1e-5)),
            "library_call": "F.rms_norm", "launch_floor_ms": time_launch_floor()}


def time_launch_floor() -> float:
    """An empty kernel launched through the kernel library on the current
    stream, timed as the kernels are: the floor of a launch on this path."""
    from repro_torch.kernels import _build

    lib = _build.library()
    return time_ms(lambda: _build.check(
        lib.empty_launch(torch.cuda.current_stream().cuda_stream), "empty_launch"))


def phase_serve() -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.serving.engine import Request

    cfg = get_arch("ds-paper-100m")
    dtype = torch.bfloat16
    model = Model(cfg, ModelRuntime(dtype=dtype))
    params = init_params(model, 0, "cuda")
    kw = dict(max_batch=16, max_len=640, prefill_chunk=16, page_size=16, cache_mode="paged")
    warm = [Request(uid=f"w{i}", prompt=list(range(1, 40 + i)), max_new_tokens=4)
            for i in range(2)]
    run_engine(model, params, warm, "cuda", **kw)

    from repro_torch.serving.engine import ServeEngine

    reqs = serve_requests(cfg.vocab_size)
    eng = ServeEngine(model, params, device="cuda", **kw)
    eng._decode, eng._prefill = DispatchTimer(eng._decode), DispatchTimer(eng._prefill)
    eng.submit(reqs)
    release_device_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    outs = {r.uid: r.output for r in eng.finished}
    require(len(outs) == len(reqs), "not every serve request finished")
    require(all(len(o) == 64 and all(0 <= t < cfg.vocab_size for t in o) for o in outs.values()),
            "a serve request emitted a wrong number of tokens or an id outside the vocab")
    d = eng.dispatches
    require(launches["paged_attention"] == cfg.n_layers * d, "paged launches != 12/dispatch")
    # a prefill dispatch (16 rows of 16 tokens, G*T 16) runs the tensor-core
    # path, a decode dispatch (G*T 1) the split-KV decode one, and nothing
    # runs the CUDA-core path
    require(launches["paged_attention_tensor_core"] == cfg.n_layers * eng.prefill_dispatches,
            f"tensor-core paged launches {launches['paged_attention_tensor_core']} != 12 per "
            f"prefill dispatch ({eng.prefill_dispatches})")
    require(launches["paged_attention_decode"] == cfg.n_layers * eng.decode_dispatches,
            f"decode-path paged launches {launches['paged_attention_decode']} != 12 per "
            f"decode dispatch ({eng.decode_dispatches})")
    require(launches["paged_attention_cuda_core"] == 0,
            f"serve launched the CUDA-core paged path {launches['paged_attention_cuda_core']} "
            "times")
    require(launches["rmsnorm"] == (2 * cfg.n_layers + 1) * d, "rmsnorm launches != 25/dispatch")
    rec = {
        "phase": "serve", "arch": cfg.name, "dtype": "bfloat16", "requests": len(reqs),
        "prompt_tokens": sum(len(r.prompt) for r in reqs), "max_new_tokens": 64,
        "max_batch": 16, "page_size": 16, "wall_s": wall,
        "tokens_emitted": eng.tokens_emitted, "tokens_per_s": eng.tokens_emitted / wall,
        "dispatches": d, "prefill_dispatches": eng.prefill_dispatches,
        "decode_dispatches": eng.decode_dispatches,
        "decode_dispatch_ms": summary(eng._decode.ms()),
        "prefill_dispatch_ms": summary(eng._prefill.ms()),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "peak_pages": eng.peak_pages, "total_pages": eng.n_pages, "launches": launches,
    }
    rng = np.random.default_rng(3)
    rec["kernel_times"] = {
        "paged_attention": {
            "decode": time_paged("decode", 16, 1, rng.integers(128, 576, 16).tolist(), dtype),
            "prefill": time_paged("prefill", 16, 16,
                                  (16 * rng.integers(0, 32, 16)).tolist(), dtype),
            # long contexts on the decode path: 2048-4096 keys, 256 pages a slot
            "decode_long": time_paged("decode_long", 16, 1,
                                      rng.integers(2047, 4096, 16).tolist(), dtype, P=256),
            # parity's f32 prefill: 4 rows of 16 tokens at page-aligned
            # offsets, 8 pages a slot (max_len 128), on the tensor-core path
            # in 3xTF32 and forced onto the CUDA-core one
            "f32_chunk_extend": time_paged("f32_chunk_extend", 4, 16, [0, 16, 32, 48],
                                           torch.float32, P=8, cuda_core=True),
        },
        "rmsnorm": {
            "decode": time_rmsnorm("decode", 16, cfg.d_model, dtype),
            "prefill": time_rmsnorm("prefill", 16 * 16, cfg.d_model, dtype),
        },
    }
    emit(rec)
    return rec


def trace(fn, reps: int, unit: str, watch: tuple = ()) -> dict:
    """Where the time of ``fn`` goes: ``reps`` calls timed on the host clock
    without the profiler, then ``reps`` more traced with torch.profiler.
    Device busy time is the sum of the traced kernels and copies (one
    stream); the idle share is 1 - busy / the unprofiled wall time, so the
    profiler's own host overhead is not counted as idle.  ``watch`` names
    substrings of device ops reported whether or not they are in the top
    8."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    # the raw Kineto events: the same device events as prof.events(), which
    # builds the whole host and device event tree in Python, some ten times
    # slower (tools/profiler_events.py)
    dev = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name()][0] += e.duration_ns() / 1e6
        by_name[e.name()][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {f"wall_ms_per_{unit}": wall_ms / reps,
            f"profiled_wall_ms_per_{unit}": profiled_wall_ms / reps,
            f"device_busy_ms_per_{unit}": busy_ms / reps,
            "device_idle_share": (1 - busy_ms / wall_ms) if dev else None,
            f"device_ops_per_{unit}": len(dev) / reps,
            "top_device_ops": [{"name": n[:80], f"ms_per_{unit}": v[0] / reps,
                                f"count_per_{unit}": v[1] / reps} for n, v in top],
            "watched_ops": {w: {f"ms_per_{unit}": sum(v[0] for n, v in by_name.items() if w in n)
                                / reps,
                                f"count_per_{unit}": sum(v[1] for n, v in by_name.items() if w in n)
                                / reps} for w in watch}}


def phase_profile() -> dict:
    """Where a decode dispatch's time goes at the serve shape: 16 rows
    decoding at once, 16 ticks timed and 16 traced (``trace``)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_arch("ds-paper-100m")
    model = Model(cfg, ModelRuntime(dtype=torch.bfloat16))
    params = init_params(model, 0, "cuda")
    rng = np.random.default_rng(4)
    eng = ServeEngine(model, params, device="cuda", max_batch=16, max_len=640,
                      prefill_chunk=16, page_size=16, cache_mode="paged")
    eng.submit([Request(uid=f"q{i}", prompt=rng.integers(1, cfg.vocab_size, 256).tolist(),
                        max_new_tokens=64) for i in range(16)])
    for _ in range(4):  # tick 1 drains every prompt; then warm decode ticks
        eng.step()
    d0 = eng.decode_dispatches
    ticks = 16
    traced = trace(eng.step, ticks, "dispatch")
    require(eng.decode_dispatches - d0 == 2 * ticks, "timed ticks were not all decode dispatches")
    rec = {"phase": "profile", "what": "decode dispatch, 16 rows, prompts 256", "ticks": ticks,
           **traced}
    emit(rec)
    return rec


# ------------------------------------------------------------------ speculative decoding
SPEC_COUNTERS = ("spec_dispatches", "draft_dispatches", "draft_tokens_proposed",
                 "draft_tokens_accepted", "spec_tokens_emitted")
DRAFT_SEED = 7  # the reference bench's draft model: the same arch from seed 7


class LaunchesPerCall:
    """Wraps a dispatch callable; records the kernel launches each call
    made (the launch counters' growth across it)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args):
        before = read_launches()
        out = self.fn(*args)
        after = read_launches()
        self.calls.append({k: after[k] - before[k] for k in after})
        return out


def require_verify_launches(eng, paged: bool, path: str, what: str) -> None:
    """Every verify dispatch of ``eng`` (wrapped in ``LaunchesPerCall``)
    launched a paged kernel a layer, all on ``path`` (none on the dense
    cache), and 2 L + 1 RMSNorm."""
    calls = eng._verify.calls
    L = eng.model.cfg.n_layers
    require(len(calls) == eng.spec_dispatches > 0,
            f"{what}: {len(calls)} verify calls for {eng.spec_dispatches} spec dispatches")
    want = L if paged else 0
    for c in calls:
        require(c["paged_attention"] == want and c[f"paged_attention_{path}"] == want
                and c["rmsnorm"] == 2 * L + 1,
                f"{what}: a verify dispatch launched {c}, not {want} paged on the {path} "
                f"path and {2 * L + 1} RMSNorm")


# The first 2 of ds-paper-100m's 12 layers (target and draft alike): the
# depth cut keeps the CPU side short; the widths and every gate stay.
SPEC_PARITY_LAYERS = 2


def phase_spec_parity() -> dict:
    """Full-width ds-paper-100m in f32 at its first ``SPEC_PARITY_LAYERS``
    layers: the speculative engines (paged ``ngram`` at ``spec_k`` 4 and 8,
    paged ``draft`` from seed 7 and from the target's own params, dense
    ``ngram``; ``spec_k`` 4 unless named) and the grouped engine on the
    card against the same engines on the CPU: equal greedy tokens
    (near-tie exception) and counters, tokens equal to the same model's
    non-speculative paged and dense engines on the card, a paged launch a
    layer and 2 L + 1 RMSNorm a verify dispatch (T 5 on the decode path,
    T 9 on the tensor-core path), none on the CUDA-core path, 2 L + 1
    RMSNorm a dispatch draft dispatches included, and rollback exercised:
    the seed-7 draft rejects, the
    self-draft keeps some drafts and loses the rest."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_decode import kernel_path
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.serving.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("ds-paper-100m"), n_layers=SPEC_PARITY_LAYERS)
    L, norms = cfg.n_layers, 2 * cfg.n_layers + 1
    model = Model(cfg, ModelRuntime(dtype=torch.float32))
    draft = Model(cfg, ModelRuntime(dtype=torch.float32))
    params = {d: init_params(model, 0, d) for d in ("cuda", "cpu")}
    draft_params = {d: init_params(draft, DRAFT_SEED, d) for d in ("cuda", "cpu")}
    base = dict(max_batch=4, max_len=128, prefill_chunk=16)
    paged = dict(base, page_size=16, cache_mode="paged")
    # the non-speculative engines on the card, which every speculative one must equal
    plain = {mode: run_engine(model, params["cuda"], parity_requests(cfg.vocab_size), "cuda",
                              **kw)[0]
             for mode, kw in (("paged", paged), ("dense", dict(base, cache_mode="dense")))}
    engines = {
        "paged_ngram": (dict(paged, speculative="ngram", spec_k=4), "paged"),
        "paged_ngram_k8": (dict(paged, speculative="ngram", spec_k=8), "paged"),
        "paged_draft": (dict(paged, speculative="draft", spec_k=4), "paged"),
        "paged_draft_self": (dict(paged, speculative="draft", spec_k=4), "paged"),
        "dense_ngram": (dict(base, cache_mode="dense", speculative="ngram", spec_k=4), "dense"),
        "paged_grouped": (dict(paged, dispatch_mode="grouped"), "paged"),
    }
    # the seed-7 draft seldom agrees with the target; the target drafting
    # for itself lands its greedy drafts until a row reaches its budget, so
    # its verify keeps a run of drafts and rewinds the rest
    drafts = {"paged_draft": (draft, draft_params), "paged_draft_self": (model, params)}
    t_phase = time.perf_counter()
    rec = {"phase": "spec_parity", "arch": cfg.name, "dtype": "float32", "layers": L,
           "draft_init_seed": DRAFT_SEED, "engines": {}}
    for name, (kw, mode) in engines.items():
        runs = {}
        for dev in ("cuda", "cpu"):
            extra = ({"draft_model": drafts[name][0], "draft_params": drafts[name][1][dev]}
                     if name in drafts else {})
            eng = ServeEngine(model, params[dev], device=dev, **kw, **extra)
            if eng._verify is not None:
                eng._verify = LaunchesPerCall(eng._verify)
            eng.submit(parity_requests(cfg.vocab_size))
            reset_launches()
            t0 = time.perf_counter()
            eng.run_to_completion()
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = read_launches()
            runs[dev] = (eng, time.perf_counter() - t0)
        gpu, cpu = runs["cuda"][0], runs["cpu"][0]
        what = f"spec_parity {name}"
        divs = compare_greedy(model, params["cpu"], gpu, cpu, f"{what}, card against CPU")
        counters = compare_counters(gpu, cpu, f"{what}, card against CPU",
                                    PARITY_COUNTERS + SPEC_COUNTERS)
        vs_plain = compare_greedy(model, params["cpu"], gpu, plain[mode],
                                  f"{what} against the non-speculative {mode} card run")
        n = gpu.dispatches + gpu.draft_dispatches
        require(launches["rmsnorm"] == norms * n,
                f"{what}: rmsnorm launched {launches['rmsnorm']} times for {n} dispatches")
        require(launches["paged_attention"] == (L * n if mode == "paged" else 0),
                f"{what}: paged attention launched {launches['paged_attention']} times for "
                f"{n} dispatches")
        # every f32 fold of dk 64 takes the decode path (up to 8 rows) or the
        # tensor-core one (3xTF32)
        require(launches["paged_attention_cuda_core"] == 0,
                f"{what}: f32 paged attention took the CUDA-core path")
        if kw.get("speculative"):
            require(gpu.decode_dispatches == gpu.spec_dispatches > 0,
                    f"{what}: not every decode dispatch was a verify dispatch")
            # G 1: T = spec_k + 1 up to 8 takes the decode path, from 9 the tensor-core one
            path = kernel_path(torch.float32, kw["spec_k"] + 1, 64, 64)
            require_verify_launches(gpu, mode == "paged", path, what)
        else:
            require(gpu.prefill_dispatches == 0 and gpu.decode_dispatches > gpu.scheduler.tick,
                    f"{what}: grouped dispatch ran fused prefill or one dispatch a tick")
            require(launches["paged_attention_decode"] == L * gpu.decode_dispatches,
                    f"{what}: decode-path launches {launches['paged_attention_decode']} != {L} "
                    f"per decode dispatch ({gpu.decode_dispatches})")
        if name in drafts:
            require(gpu.draft_dispatches > 0
                    and gpu.draft_tokens_accepted < gpu.draft_tokens_proposed,
                    f"{what}: the draft run never rolled back")
        if name == "paged_draft_self":
            require(gpu.draft_tokens_accepted > 0,
                    f"{what}: the self-draft had no draft accepted")
        rec["engines"][name] = {
            "spec_k": kw.get("spec_k"), "tokens_equal": not divs, "divergences": divs,
            "tokens_equal_to_plain": not vs_plain, "divergences_from_plain": vs_plain,
            "counters_card_cpu": counters, "launches": launches,
            "accepted_per_dispatch": gpu.stats.snapshot()["accepted_per_dispatch"],
            "card_s": runs["cuda"][1], "cpu_s": runs["cpu"][1]}
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def decode_heavy_requests(n_requests: int, max_new: int, seed: int = 11):
    """Short prompts, long generations (a copy of the reference bench's
    ``decode_heavy_requests``): almost every dispatch is a decode tick."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=f"d{i}",
                    prompt=[int(t) for t in rng.integers(1, 200, size=int(rng.integers(4, 12)))],
                    max_new_tokens=max_new)
            for i in range(n_requests)]


# Depth cuts for the script's time limit: spec_serve runs 4 of ds-paper-100m's
# 12 layers, ds_serve and ds_store's bf16 leases 4, train and eval 2.
SPEC_SERVE_LAYERS = 2
DS_SERVE_LAYERS = 2
TRAIN_LAYERS = 2
SPEC_SERVE_KW = dict(max_batch=8, max_len=288, prefill_chunk=16, page_size=16,
                     cache_mode="paged")
SPEC_SERVE_NEW = 256


def phase_spec_serve() -> dict:
    """Full-width ds-paper-100m in bf16 at its first ``SPEC_SERVE_LAYERS``
    layers, 8 decode-heavy requests of 256 new
    tokens through the plain engine, ``ngram`` at ``spec_k`` 8 (verify T 9:
    the tensor-core path) and ``draft`` at ``spec_k`` 4 (T 5: the decode
    path): tokens/s, dispatches per token, accepted per dispatch, verify
    dispatch times, launches by path (one a layer a verify dispatch on its path),
    peak memory, one traced verify tick each, tokens against the plain run
    reported (bf16 verify rounds unlike T sequential decodes: not gated),
    and the paged kernel at the verify shapes."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_decode import kernel_path
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(get_arch("ds-paper-100m"), n_layers=SPEC_SERVE_LAYERS)
    L = cfg.n_layers
    dtype = torch.bfloat16
    model = Model(cfg, ModelRuntime(dtype=dtype))
    params = init_params(model, 0, "cuda")
    draft = Model(cfg, ModelRuntime(dtype=dtype))
    draft_params = init_params(draft, DRAFT_SEED, "cuda")
    modes = {
        "off": ({}, None),
        "ngram": (dict(speculative="ngram", spec_k=8), kernel_path(dtype, 9, 64, 64)),
        "draft": (dict(speculative="draft", spec_k=4, draft_model=draft,
                       draft_params=draft_params), "decode"),
    }
    # the gap of a divergence: f32 on the CPU with the same (bf16) weights
    f32_model = Model(cfg, ModelRuntime(dtype=torch.float32))
    params_cpu = cast_params(params, torch.float32, "cpu")
    t_phase = time.perf_counter()
    rec = {"phase": "spec_serve", "arch": cfg.name, "dtype": "bfloat16",
           "requests": 8, "max_new_tokens": SPEC_SERVE_NEW, **SPEC_SERVE_KW,
           "draft_init_seed": DRAFT_SEED, "engines": {}}
    launches_total: dict = {}
    engines = {}
    for name, (extra, path) in modes.items():
        run_engine(model, params, decode_heavy_requests(2, 8, seed=5), "cuda",
                   **SPEC_SERVE_KW, **extra)  # warm the shapes
        reqs = decode_heavy_requests(8, SPEC_SERVE_NEW)
        eng = ServeEngine(model, params, device="cuda", **SPEC_SERVE_KW, **extra)
        eng._decode, eng._prefill = DispatchTimer(eng._decode), DispatchTimer(eng._prefill)
        if eng._verify is not None:
            eng._verify = LaunchesPerCall(DispatchTimer(eng._verify))
        eng.submit(reqs)
        release_device_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        for k, v in launches.items():
            launches_total[k] = launches_total.get(k, 0) + v
        outs = {r.uid: r.output for r in eng.finished}
        require(len(outs) == 8 and all(len(o) == SPEC_SERVE_NEW
                                       and all(0 <= t < cfg.vocab_size for t in o)
                                       for o in outs.values()),
                f"spec_serve {name}: a request did not finish with {SPEC_SERVE_NEW} tokens in "
                "the vocab")
        n = eng.dispatches + eng.draft_dispatches
        require(launches["paged_attention"] == L * n and launches["rmsnorm"] == (2 * L + 1) * n,
                f"spec_serve {name}: launches {launches} for {n} dispatches")
        if path is not None:
            require_verify_launches(eng, True, path, f"spec_serve {name}")
        engines[name] = eng
        snap = eng.stats.snapshot()
        rec["engines"][name] = {
            "spec_k": extra.get("spec_k"), "verify_path": path, "wall_s": wall,
            "tokens_emitted": eng.tokens_emitted, "tokens_per_s": eng.tokens_emitted / wall,
            "dispatches": eng.dispatches, "decode_dispatches": eng.decode_dispatches,
            "prefill_dispatches": eng.prefill_dispatches,
            "dispatches_per_token": eng.dispatches / eng.tokens_emitted,
            "spec_dispatches": eng.spec_dispatches, "draft_dispatches": eng.draft_dispatches,
            "draft_tokens_proposed": eng.draft_tokens_proposed,
            "draft_tokens_accepted": eng.draft_tokens_accepted,
            "accepted_per_dispatch": snap["accepted_per_dispatch"],
            "verify_dispatch_ms": summary(eng._verify.fn.ms()) if path else None,
            "decode_dispatch_ms": summary(eng._decode.ms()),
            "prefill_dispatch_ms": summary(eng._prefill.ms()),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches}
        if name != "off":
            t0 = time.perf_counter()
            rec["engines"][name]["divergences_from_off"] = divergences(
                f32_model, params_cpu, eng, engines["off"], f"spec_serve {name} against off")
            rec["engines"][name]["divergences_s"] = time.perf_counter() - t0
    rec["launches"] = launches_total
    # one verify tick each, traced: 8 rows decoding, prompts ingested first
    rec["profile"] = {}
    for name in ("ngram", "draft"):
        eng = ServeEngine(model, params, device="cuda", **dict(SPEC_SERVE_KW, max_len=640),
                          **modes[name][0])
        eng.submit(decode_heavy_requests(8, 600, seed=13))
        for _ in range(4):
            eng.step()
        d0 = eng.spec_dispatches
        traced = trace(eng.step, 16, "tick", watch=("paged_", "rmsnorm"))
        require(eng.spec_dispatches - d0 == 32, f"spec_serve {name}: a traced tick was not "
                "one verify dispatch")
        rec["profile"][name] = {"what": f"verify tick, 8 rows, {name} spec_k "
                                        f"{modes[name][0]['spec_k']}", **traced}
    del engines
    release_device_memory()
    rng = np.random.default_rng(6)
    rec["kernel_times"] = {"paged_attention": {
        f"verify_T{T}": time_paged(f"verify_T{T}", 16, T,
                                   rng.integers(128, 576 - T + 1, 16).tolist(), dtype)
        for T in (5, 9)}}
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


# ------------------------------------------------------------------ training
def heartbeat_events(events: list):
    """A heartbeat for the job runners that records a CUDA event each
    time it is called (after a step's loss has reached the host)."""

    def beat(progress=None):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)

    return beat


def event_intervals_ms(events: list) -> list:
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


# Tolerances of the card against the CPU, f32 on both (no TF32): losses and
# gradient norms differ only by summation order (rtol 1e-4).  A parameter
# moves by at most ~lr per Adam step, so a near-zero gradient whose sign
# differs between the devices moves it by at most 2 * (lr_1 + lr_2) =
# 9e-5 over the two steps (lr 1.5e-5 then 3e-5, the job defaults'
# warmup); parameters are held at atol 1e-4 + rtol 1e-4.
PARITY_RTOL = 1e-4
PARITY_PARAM_ATOL = 1e-4


def train_steps(job: dict, device: str, seq_len: int, batch: int, params=None,
                steps: int = 2):
    """``steps`` steps of ``job``'s model through the payload's
    ``build_model``, ``build_train_step`` and AdamW, from ``params`` (seed
    0's ``init_params`` when None; the step is functional and leaves them
    untouched): each step's loss, grad_norm and wall ms (the loss read
    back ends it), and the final tree."""
    from repro_torch import prng
    from repro_torch.launch.train import build_model, build_train_step
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import init_opt_state

    model = build_model(job)
    step_fn, opt_cfg = build_train_step(job, model)
    data = SyntheticLM(model.cfg, DataConfig(seq_len=seq_len, global_batch=batch), device=device)
    if params is None:
        params = init_params(model, 0, device)
    opt = init_opt_state(params, opt_cfg)
    metrics = []
    for step in range(steps):
        t0 = time.perf_counter()
        params, opt, met = step_fn(params, opt, data.batch(step), prng.PRNGKey(step, device=device))
        metrics.append({"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                        "step_ms": (time.perf_counter() - t0) * 1e3})
    return metrics, params


# train_parity runs 1 of ds-paper-100m's 12 layers at full width: at all 12
# its CPU side (2 x 2 full-width f32 steps, 135M-element threefry draws)
# took 55 s on the host of a one-H100 machine, at 4 layers 24.5 s.  The
# int8 microbatch run takes one step, for the time limit: its CPU side was
# 19.2 s for two.
TRAIN_PARITY_LAYERS = 1
TRAIN_PARITY_STEPS = {"one_batch": 2, "microbatches2_int8": 1}


def phase_train_parity() -> dict:
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {"one_batch": {}, "microbatches2_int8": {"microbatches": 2, "accum_dtype": "int8"}}
    rec = {"phase": "train_parity", "arch": "ds-paper-100m", "dtype": "float32",
           "layers": TRAIN_PARITY_LAYERS, "tokens": "2 x 128", "steps": TRAIN_PARITY_STEPS,
           "rtol": PARITY_RTOL, "param_atol": PARITY_PARAM_ATOL, "runs": {}}
    for name, extra in runs.items():
        job = {"arch": "ds-paper-100m", "arch_overrides": {"n_layers": TRAIN_PARITY_LAYERS},
               **extra}
        t0 = time.perf_counter()
        reset_launches()
        steps = TRAIN_PARITY_STEPS[name]
        card, card_params = train_steps(job, "cuda", 128, 2, steps=steps)
        card_launches = read_launches()["rmsnorm"]
        card_s = time.perf_counter() - t0
        card_params = [p.cpu() for p in tree_leaves(card_params)]
        t0 = time.perf_counter()
        cpu, cpu_params = train_steps(job, "cpu", 128, 2, steps=steps)
        cpu_s = time.perf_counter() - t0
        worst = 0.0
        for a, b in zip(card_params, tree_leaves(cpu_params)):
            worst = max(worst, (a - b).abs().max().item())
            require(bool(torch.allclose(a, b, atol=PARITY_PARAM_ATOL, rtol=PARITY_RTOL)),
                    f"train_parity {name}: parameters after {steps} steps differ (max {worst})")
        for step, (c, h) in enumerate(zip(card, cpu)):
            for key in ("loss", "grad_norm"):
                require(math.isfinite(c[key]) and abs(c[key] - h[key]) <= PARITY_RTOL * abs(h[key]),
                        f"train_parity {name}: {key} at step {step} card {c[key]} cpu {h[key]}")
        # one forward and one backward per microbatch; norms run forward only
        per_step = (2 * TRAIN_PARITY_LAYERS + 1) * job.get("microbatches", 1)
        require(card_launches == steps * per_step,
                f"rmsnorm launched {card_launches} times in {steps} training steps")
        rec["runs"][name] = {"card": card, "cpu": cpu, "param_max_abs_err": worst,
                             "card_s": card_s, "cpu_s": cpu_s,
                             "rmsnorm_launches": card_launches}
    emit(rec)
    return rec


TRAIN_JOB = {"arch": "ds-paper-100m", "arch_overrides": {"n_layers": TRAIN_LAYERS},
             "run": "smoke", "seq_len": 512, "global_batch": 8}


def phase_train(store_root: Path) -> dict:
    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch.train import run_train_span
    from repro_torch.train.checkpoint import checkpoint_exists

    torch.backends.cuda.matmul.allow_tf32 = False
    store = ObjectStore(str(store_root / "interrupted"))
    events: list = []
    release_device_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    first = run_train_span({**TRAIN_JOB, "start_step": 0, "num_steps": 20}, store,
                           heartbeat_events(events), device="cuda")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    step_ms = event_intervals_ms(events)
    require(len(first["losses"]) == 20 and all(math.isfinite(x) for x in first["losses"]),
            "the 20 training losses are not all finite")
    require(checkpoint_exists(store, "smoke", 20), "no checkpoint at step 20")
    norms = 2 * TRAIN_LAYERS + 1
    require(launches["rmsnorm"] == 20 * norms and launches["flash_attention"] == 0,
            f"training launches {launches}: want {norms} RMSNorm per step and no flash kernel")
    resumed = run_train_span({**TRAIN_JOB, "start_step": 20, "num_steps": 2}, store,
                             lambda progress=None: None, device="cuda")
    whole = run_train_span({**TRAIN_JOB, "start_step": 0, "num_steps": 22},
                           ObjectStore(str(store_root / "uninterrupted")),
                           lambda progress=None: None, device="cuda")
    for got, want in zip(first["losses"] + resumed["losses"], whole["losses"]):
        require(abs(got - want) <= PARITY_RTOL * abs(want),
                f"resumed training diverges from the uninterrupted run: {got} vs {want}")
    tokens = TRAIN_JOB["seq_len"] * TRAIN_JOB["global_batch"]
    med = summary(step_ms)["median"]
    rec = {"phase": "train", "arch": "ds-paper-100m", "dtype": "float32",
           "tokens_per_step": tokens, "losses": first["losses"],
           "resumed_losses": resumed["losses"], "uninterrupted_losses": whole["losses"][20:],
           "step_ms": summary(step_ms), "tokens_per_s": tokens / (med / 1e3),
           "max_memory_allocated_bytes": peak, "launches": launches,
           "profile": trace_train_step()}
    emit(rec)
    return rec


def trace_train_step() -> dict:
    """Where a full-width f32 train step's time goes (8 x 512 tokens, the
    span runner's step on its own: 3 steps timed, 3 traced)."""
    from repro_torch import prng
    from repro_torch.launch.train import build_model, build_train_step
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import init_opt_state

    model = build_model(TRAIN_JOB)
    step_fn, opt_cfg = build_train_step(TRAIN_JOB, model)
    batch = SyntheticLM(model.cfg, DataConfig(seq_len=TRAIN_JOB["seq_len"],
                                              global_batch=TRAIN_JOB["global_batch"]),
                        device="cuda").batch(0)
    state = {"params": init_params(model, 0, "cuda")}
    state["opt"] = init_opt_state(state["params"], opt_cfg)
    key = prng.PRNGKey(0, device="cuda")

    def one_step():
        state["params"], state["opt"], met = step_fn(state["params"], state["opt"], batch, key)
        float(met["loss"])

    one_step()  # warm
    return {"what": "f32 train step, 8 x 512 tokens", **trace(one_step, 3, "step")}


def flash_work(bh: int, s: int, hd: int, dtype, window: int = 0, *, skv: int = 0,
               causal: bool = True) -> tuple:
    """Bytes (q, k, v read once, out written once) and flops: causal, 2 *
    BH * S^2 * hd (QK and PV over the lower triangle; with a window W, 4 *
    BH * hd over the W (W + 1) / 2 + (S - W) W pairs in it); non-causal,
    over ``s`` queries and ``skv`` keys (``s`` by default), 4 * BH * S *
    Skv * hd (every pair)."""
    item = torch.tensor([], dtype=dtype).element_size()
    skv = skv or s
    nbytes = 2 * bh * (s + skv) * hd * item
    if not causal:
        return nbytes, 4 * bh * s * skv * hd
    if window and window < s:
        return nbytes, 4 * bh * hd * (window * (window + 1) // 2 + (s - window) * window)
    return nbytes, 2 * bh * s * s * hd


def time_flash(bh: int, s: int, dtype, hd: int = 64, window: int = 0, *, skv: int = 0,
               causal: bool = True) -> dict:
    """The flash kernel over ``bh`` heads of ``s`` queries (and ``skv`` keys,
    ``s`` by default), causal or not, held against its plain version and
    timed beside its bound, its plain version and SDPA (a window as a
    boolean mask; no mask when not causal)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_bhsd,
        flash_attention_bhsd_plain,
    )

    skv = skv or s
    gen = torch.Generator(device="cuda").manual_seed(23)
    q = torch.randn((bh, s, hd), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((bh, skv, hd), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    blocks = {} if causal else dict(block_q=s, block_k=skv)  # the model's blocks
    kern = lambda: flash_attention_bhsd(q, k, v, causal=causal, window=window,  # noqa: E731
                                        **blocks)
    plain = lambda: flash_attention_bhsd_plain(q, k, v, causal=causal,  # noqa: E731
                                               window=window)
    # SDPA takes its fast kernels for (batch, heads, S, hd): the same folded
    # tensors with a unit batch axis; a window as a boolean mask
    if not causal:
        lib = lambda: F.scaled_dot_product_attention(q[None], k[None], v[None])  # noqa: E731
    elif window:
        pos = torch.arange(s, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[None], k[None], v[None], attn_mask=mask)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[None], k[None], v[None], is_causal=True)
    err = check_at_shape(f"flash attention ({bh}x{s}x{skv}, window {window}, causal {causal})",
                         kern, plain, dtype)
    nbytes, flops = flash_work(bh, s, hd, dtype, window, skv=skv, causal=causal)
    bms, by = bound(nbytes, flops, dtype)
    route = {"bound_route": "bf16 tensor cores, 989 TFLOP/s"}
    if dtype == torch.float32:
        # the f32 kernel runs 3xTF32 on the tensor cores: its bound is three
        # TF32 passes; the CUDA-core figure stands beside it
        route = {"bound_route": "3xTF32 tensor cores: 3 passes at 494.7 TFLOP/s",
                 "bound_ms_cuda_core": bms, "bound_by_cuda_core": by}
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_OPS
        bms, by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
    shape = {"BH": bh, "S": s, "hd": hd, "window": window}
    if not causal:
        shape.update(Skv=skv, causal=False)
    return {"shape": shape, "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err": err, "ms": time_ms(kern), "plain_ms": time_ms(plain, iters=10),
            "bound_ms": bms, "bound_by": by, **route, "library_ms": time_ms(lib),
            "library_call": "F.scaled_dot_product_attention on the folded tensors viewed as "
                            "(1, BH, S, hd), " + ("no mask" if not causal else
                                                  "a boolean window mask" if window
                                                  else "is_causal=True")}


EVAL_SHAPES = ((8, 512), (2, 4096))
# Logits with the flash kernel against direct attention: f32 differs by
# summation order only; in bf16 the direct path rounds its probabilities
# to bf16 before P.V (as the reference) while the kernel keeps fp32, and
# the difference compounds over 12 layers of bf16 activations.
EVAL_LOGIT_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-1}


def phase_eval(store_root: Path) -> dict:
    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch.train import build_model, run_eval
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.train.checkpoint import latest_step, restore_state
    from repro_torch.train.data import DataConfig, SyntheticLM

    torch.backends.cuda.matmul.allow_tf32 = False
    store = ObjectStore(str(store_root / "interrupted"))
    n_batches = 3
    rec = {"phase": "eval", "arch": "ds-paper-100m", "ckpt_step": latest_step(store, "smoke"),
           "runs": [], "kernel_times": []}
    for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        job = {**TRAIN_JOB, "dtype": name, "n_batches": n_batches}
        base = build_model(job)
        params, _ = restore_state(store, "smoke", rec["ckpt_step"], base.abstract_params(),
                                  device="cuda")
        for b, s in EVAL_SHAPES:
            events: list = []
            reset_launches()
            out = run_eval({**job, "seq_len": s, "global_batch": b}, store,
                           heartbeat_events(events), device="cuda")
            launches = read_launches()
            ms = event_intervals_ms(events)
            L = base.cfg.n_layers
            require(launches["flash_attention"] == L * n_batches
                    and launches["rmsnorm"] == (2 * L + 1) * n_batches,
                    f"eval {name} {b}x{s}: launches {launches}, want {L} flash and {2 * L + 1} "
                    "RMSNorm per forward")
            require(math.isfinite(out["loss"]), f"eval {name} {b}x{s}: loss not finite")
            batch = SyntheticLM(base.cfg, DataConfig(seq_len=s, global_batch=b, seed=1234),
                                device="cuda").batch(0)
            with torch.no_grad():
                logits = {impl: Model(base.cfg, ModelRuntime(dtype=dtype, attn_impl=impl))
                          .forward(params, batch["tokens"]) for impl in ("kernel", "direct")}
            err = (logits["kernel"] - logits["direct"]).abs().max().item()
            t = EVAL_LOGIT_TOL[dtype]
            require(bool(torch.isfinite(logits["kernel"]).all())
                    and bool(torch.allclose(logits["kernel"], logits["direct"], atol=t, rtol=t)),
                    f"eval {name} {b}x{s}: kernel logits differ from direct by {err}")
            del logits
            evaluator = Model(base.cfg, ModelRuntime(dtype=dtype))
            with torch.no_grad():
                profile = trace(lambda: float(evaluator.loss(params, batch)[0]), 3, "forward")
            rec["runs"].append({
                "dtype": name, "batch": b, "seq_len": s, "loss": out["loss"], "ppl": out["ppl"],
                "forward_ms": summary(ms), "tokens_per_s": b * s / (summary(ms)["median"] / 1e3),
                "launches": launches,
                "launches_per_forward": {k: v / n_batches for k, v in launches.items()},
                "logits_kernel_vs_direct_max_abs_err": err, "logits_tol": t,
                "profile": profile})
            rec["kernel_times"].append(time_flash(b * base.cfg.n_heads, s, dtype))
        del params
    emit(rec)
    return rec


# ------------------------------------------------------------------ the control plane
DS_CONFIG = {"tasks_per_machine": 1, "cluster_machines": 1, "machine_type": ["sim.large"],
             "machine_price": 1.0, "sqs_message_visibility": 600.0, "max_receive_count": 3,
             "check_if_done": False}
# The train spans and eval shards run the first 2 of ds-paper-100m's 12
# layers at full width (a depth cut for the script's time limit)
DS_TRAIN_LAYERS = 2
DS_TRAIN = {"arch": "ds-paper-100m", "arch_overrides": {"n_layers": DS_TRAIN_LAYERS},
            "seq_len": 256, "global_batch": 4}
# parity's engine knobs as a distributed-serve job (no "device": it runs on cuda)
DS_SERVE_F32 = {"arch": "ds-paper-100m", "max_new_tokens": 24, "max_batch": 4, "max_len": 128,
                "prefill_chunk": 16, "cache_mode": "paged", "page_size": 16}
# the reference's revocation-drill workload (tests/test_elastic_serving.py), no prefix store
DS_DRILL = {"arch": "ds-paper-100m", "max_new_tokens": 12, "max_len": 32, "max_batch": 2,
            "prefill_chunk": 4, "cache_mode": "paged", "page_size": 8, "prefix_cache": True}
DS_TICK = 30.0
# ds_parity's mamba2 job runs 3 of the 48 layers: the depth cut saves most
# of the full-width seed draw's time
DS_SSM_LAYERS = 3


def ds_commands(workdir: Path, app: str, config: dict, job: dict, *, foreground: bool = True):
    """The paper's four commands through ``run_ds.main`` (their printed
    lines kept off this script's output): setup, submitJob, startCluster
    (``--foreground``: the worker host's ThreadRunner runs here, so its
    launches are counted) and monitor.  Returns the workdir's store."""
    import contextlib
    import io

    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch import run_ds

    files = workdir / "files"
    files.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, obj in (("config", {"app_name": app, **DS_CONFIG, **config}), ("job", job),
                      ("fleet", {"startup_seconds": 0.0})):
        paths[name] = str(files / f"{name}.json")
        Path(paths[name]).write_text(json.dumps(obj))
    wd = str(workdir / "wd")
    steps = [["setup", "--config", paths["config"]], ["submitJob", paths["job"]],
             ["startCluster", paths["fleet"], *(["--foreground"] if foreground else [])]]
    if foreground:
        steps.append(["monitor", "--poll", "0.05"])
    with contextlib.redirect_stdout(io.StringIO()):
        for argv in steps:
            require(run_ds.main(["--workdir", wd, *argv]) == 0, f"{app}: run_ds {argv[0]} failed")
    return ObjectStore(str(workdir / "wd" / "store"))


def ds_request_queue(path: Path, bodies: list) -> str:
    from repro_torch.core.queue import DurableQueue

    q = DurableQueue(str(path))
    q.send_batch(bodies)
    q.close()
    return str(path)


def ds_queue_counts(path: str) -> dict:
    from repro_torch.core.queue import DurableQueue

    q = DurableQueue(path)
    counts = q.counts()
    q.close()
    return counts


def ds_completions(results: dict) -> dict:
    return {uid: r["completion"] for uid, r in results["requests"].items()}


def ds_job_results(store, app: str) -> list:
    """The results of every completed job, from the worker host's exported
    logs (``logs/<app>/``)."""
    out = []
    for info in store.list(f"logs/{app}/"):
        for line in store.get_text(info.key).splitlines():
            event = json.loads(line)
            if event.get("message") == "job complete":
                out.append(event["result"])
    return out


def as_finished(outputs: dict, prompts: dict):
    """Completions in the shape ``divergences`` reads an engine run in."""
    import types

    return types.SimpleNamespace(finished=[
        types.SimpleNamespace(uid=u, prompt=prompts[u], output=o) for u, o in outputs.items()])


def ds_compare_greedy(model, got: dict, want: dict, prompts: dict, what: str) -> list:
    """Equal greedy completions, or a near-tie (``compare_greedy``'s CPU
    top-2 gap) at each first difference; the CPU weights are drawn only
    when the completions differ."""
    if got == want:
        return []
    params_cpu = init_params(model, 0, "cpu")
    return compare_greedy(model, params_cpu, as_finished(got, prompts),
                          as_finished(want, prompts), what)


def ds_lease_counter(store, prefix: str, name: str) -> int:
    """A counter summed over each worker's last record under ``prefix``:
    its final ``RESULTS-<worker>.json`` supersedes its slice and drain
    records under ``leases/`` (the reference's drill aggregation)."""
    finals, slices = {}, {}
    for info in store.list(prefix):
        base = info.key.rsplit("/", 1)[-1][:-len(".json")]
        if "/leases/" in info.key:
            slices[base] = store.get_json(info.key)
        elif "/RESULTS-" in info.key:
            finals[base.split("RESULTS-", 1)[-1]] = store.get_json(info.key)
    return sum(int(v.get(name, 0)) for v in {**slices, **finals}.values())


def add_launches(total: dict, launches: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in launches.items()}


def phase_ds_parity(root: Path, plain: dict) -> dict:
    """The control plane and its payloads on the card, f32 full-width
    ds-paper-100m from seed 0, through the paper's four commands
    (``startCluster --foreground``): train spans against a direct span run,
    eval shards against direct ``run_eval``, a static serve job and a
    streaming lease against ``parity``'s card engine, two streaming leases
    at once, a seeded revocation drill on the ``SimRunner``, and a static
    mamba2-1.3b serve job against a direct engine.  No job names a device:
    each runs on cuda."""
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.core import DSConfig, DSRuntime, FleetFile, JobFile, SimRunner, VirtualClock
    from repro_torch.core.chaos import ChaosMonkey
    from repro_torch.core.jobs import step_span_job_file
    from repro_torch.core.queue import DurableQueue
    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch import serve
    from repro_torch.launch.train import build_model, run_eval, run_train_span
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.train.checkpoint import latest_step, restore_state
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = get_arch("ds-paper-100m")
    L = cfg.n_layers
    rec = {"phase": "ds_parity", "arch": cfg.name, "dtype": "float32", "device_in_jobs": False,
           "runs": {}}
    total: dict = {}

    # -- train: 2 spans of 2 steps at 4 x 256 against one direct 4-step span
    jf = step_span_job_file(arch="ds-paper-100m", total_steps=4, span=2, run="ds",
                            shared=dict(DS_TRAIN, total_steps=4))
    t0 = time.perf_counter()
    reset_launches()
    store = ds_commands(root / "train", "DSTrain", {"payload": "distributed-train"},
                        json.loads(jf.to_json()))
    launches = read_launches()
    total = add_launches(total, launches)
    ds_s = time.perf_counter() - t0
    spans = sorted(ds_job_results(store, "DSTrain"), key=lambda r: r["span"][0])
    ds_losses = [x for r in spans for x in r["losses"]]
    require(latest_step(store, "ds") == 4 and len(ds_losses) == 4,
            f"ds_parity train: checkpoint at {latest_step(store, 'ds')}, losses {ds_losses}")
    Lt = DS_TRAIN_LAYERS
    require(launches["rmsnorm"] == 4 * (2 * Lt + 1) and launches["flash_attention"] == 0
            and launches["paged_attention"] == 0,
            f"ds_parity train: launches {launches}, want {2 * Lt + 1} RMSNorm a step and no "
            "attention kernel")
    direct_store = ObjectStore(str(root / "train_direct"))
    direct = run_train_span({**DS_TRAIN, "total_steps": 4, "run": "ds", "start_step": 0,
                             "num_steps": 4}, direct_store, lambda progress=None: None,
                            device="cuda")
    for step, (got, want) in enumerate(zip(ds_losses, direct["losses"])):
        require(abs(got - want) <= PARITY_RTOL * abs(want),
                f"ds_parity train: loss at step {step} {got} against direct {want}")
    like = build_model(DS_TRAIN).abstract_params()
    a, _ = restore_state(store, "ds", 4, like, device="cuda")
    b, _ = restore_state(direct_store, "ds", 4, like, device="cuda")
    worst = max((x - y).abs().max().item() for x, y in zip(tree_leaves(a), tree_leaves(b)))
    require(all(bool(torch.allclose(x, y, atol=PARITY_PARAM_ATOL, rtol=PARITY_RTOL))
                for x, y in zip(tree_leaves(a), tree_leaves(b))),
            f"ds_parity train: parameters at step 4 differ from the direct run by {worst}")
    del a, b
    rec["runs"]["train"] = {"losses": ds_losses, "direct_losses": direct["losses"],
                            "param_max_abs_err": worst, "launches": launches, "wall_s": ds_s}

    # -- eval: 2 shards on that checkpoint against direct run_eval
    eval_root = root / "eval"
    shutil.copytree(root / "train" / "wd" / "store" / "ckpt" / "ds" / "4",
                    eval_root / "wd" / "store" / "ckpt" / "ds" / "4")
    eval_job = {**DS_TRAIN, "run": "ds", "n_batches": 1}
    t0 = time.perf_counter()
    reset_launches()
    store = ds_commands(eval_root, "DSEval", {"payload": "distributed-eval"},
                        {**eval_job, "groups": [{"shard": 0}, {"shard": 1}]})
    launches = read_launches()
    total = add_launches(total, launches)
    ds_s = time.perf_counter() - t0
    require(launches["flash_attention"] == 2 * Lt and launches["rmsnorm"] == 2 * (2 * Lt + 1),
            f"ds_parity eval: launches {launches}, want {Lt} flash and {2 * Lt + 1} RMSNorm a "
            "shard")
    metrics = []
    for shard in (0, 1):
        got = store.get_json(f"runs/ds/eval/shard{shard}/METRICS.json")
        want = run_eval({**eval_job, "shard": shard, "output_prefix": f"direct/shard{shard}"},
                        store, lambda progress=None: None, device="cuda")
        require(got["ckpt_step"] == want["ckpt_step"] == 4 and got["shard"] == shard
                and abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
                and abs(got["ppl"] - want["ppl"]) <= 1e-6 * abs(want["ppl"]),
                f"ds_parity eval shard {shard}: {got} against direct {want}")
        metrics.append({"ds": got, "direct": want, "bitwise_equal": got == want})
    rec["runs"]["eval"] = {"metrics": metrics, "launches": launches, "wall_s": ds_s}

    # -- serve: parity's 6 requests, static batch and one streaming lease
    reqs = parity_requests(cfg.vocab_size)
    prompts = {r.uid: r.prompt for r in reqs}
    card = {r.uid: r.output for r in plain["paged"].finished}
    t0 = time.perf_counter()
    reset_launches()
    store = ds_commands(root / "serve_static", "DSServe", {"payload": "distributed-serve"},
                        {**DS_SERVE_F32, "groups": [{"prompts": [r.prompt for r in reqs],
                                                     "output_prefix": "serve/static"}]})
    launches = read_launches()
    total = add_launches(total, launches)
    res = store.get_json("serve/static/RESULTS.json")
    got = {f"p{u.removeprefix('req')}": o for u, o in ds_completions(res).items()}
    require(got == card, "ds_parity serve: the static job's completions differ from parity's "
                         "card engine")
    counters = {c: [res[c], getattr(plain["paged"], c)] for c in PARITY_COUNTERS}
    require(all(a == b for a, b in counters.values()),
            f"ds_parity serve: counters differ from parity's card engine: {counters}")
    d = res["dispatches"]
    require(launches["paged_attention"] == L * d and launches["rmsnorm"] == (2 * L + 1) * d,
            f"ds_parity serve: launches {launches} for {d} dispatches")
    rec["runs"]["serve_static"] = {"tokens_equal": True, "counters": counters,
                                   "launches": launches, "wall_s": time.perf_counter() - t0}

    bodies = [{"uid": r.uid, "prompt": r.prompt, "max_new_tokens": 24} for r in reqs]
    lease = {**DS_SERVE_F32, "expected_requests": 6, "stream_idle_polls": 200}
    t0 = time.perf_counter()
    rq = ds_request_queue(root / "stream_requests.sqlite", bodies)
    reset_launches()
    store = ds_commands(root / "serve_stream", "DSStream", {"payload": "distributed-serve"},
                        {**lease, "groups": [{"request_queue": rq,
                                              "output_prefix": "serve/stream"}]})
    launches = read_launches()
    total = add_launches(total, launches)
    res = store.get_json("serve/stream/RESULTS.json")
    counts = ds_queue_counts(rq)
    require(ds_completions(res) == card, "ds_parity stream: completions differ from parity's "
                                         "card engine")
    require(counts == {"visible": 0, "in_flight": 0, "dead": 0},
            f"ds_parity stream: request queue ends {counts}")
    d = res["dispatches"]
    require(launches["paged_attention"] == L * d and launches["rmsnorm"] == (2 * L + 1) * d,
            f"ds_parity stream: launches {launches} for {d} dispatches")
    rec["runs"]["serve_stream"] = {"tokens_equal": True, "queue": counts, "dispatches": d,
                                   "launches": launches, "wall_s": time.perf_counter() - t0}

    # -- two streaming leases at once on the one card, 3 requests each
    t0 = time.perf_counter()
    groups = []
    for i, part in enumerate((bodies[:3], bodies[3:])):
        groups.append({"request_queue": ds_request_queue(root / f"pair_{i}.sqlite", part),
                       "output_prefix": f"serve/pair{i}", "expected_requests": 3})
    reset_launches()
    with LeaseProbe() as probe:
        store = ds_commands(root / "serve_pair", "DSPair",
                            {"payload": "distributed-serve", "tasks_per_machine": 2},
                            {**lease, "groups": groups})
    launches = read_launches()
    total = add_launches(total, launches)
    pair = [store.get_json(f"serve/pair{i}/RESULTS.json") for i in (0, 1)]
    got = {**ds_completions(pair[0]), **ds_completions(pair[1])}
    model = serve._cached_model(DS_SERVE_F32)
    divs = ds_compare_greedy(model, got, card, prompts, "ds_parity two leases")
    d = sum(r["dispatches"] for r in pair)
    require(launches["paged_attention"] == L * d and launches["rmsnorm"] == (2 * L + 1) * d,
            f"ds_parity two leases: launches {launches} are not the sum over both leases' "
            f"{d} dispatches")
    spans = sorted(probe.spans)
    require(len(spans) == 2, f"ds_parity two leases: {len(spans)} lease calls")
    for i in (0, 1):
        counts = ds_queue_counts(groups[i]["request_queue"])
        require(counts == {"visible": 0, "in_flight": 0, "dead": 0},
                f"ds_parity two leases: request queue {i} ends {counts}")
    rec["runs"]["two_leases"] = {
        "tokens_equal": not divs, "divergences": divs,
        "dispatches": [r["dispatches"] for r in pair], "launches": launches,
        "lease_wall_s": [b - a for a, b in spans],
        "overlap_s": max(0.0, min(b for _, b in spans) - max(a for a, _ in spans)),
        "wall_s": time.perf_counter() - t0}

    # -- a seeded revocation drill on the SimRunner: one revocation notice
    t0 = time.perf_counter()
    serve.reset_serve_state()
    clk = VirtualClock()
    drill_cfg = DSConfig(app_name="DSDrill", payload="distributed-serve", cluster_machines=1,
                         tasks_per_machine=1, machine_type=["sim.large"], machine_price=1.0,
                         cpu_shares=8192, memory_mb=16384, sqs_message_visibility=240.0,
                         check_if_done=False, idle_alarm_seconds=100_000.0,
                         monitor_poll_seconds=DS_TICK, autoscale="queue", min_workers=1,
                         max_workers=2, autoscale_queue_per_worker=2,
                         autoscale_up_cooldown_seconds=DS_TICK,
                         autoscale_down_cooldown_seconds=3600.0)
    rt = DSRuntime(drill_cfg, store_root=str(root / "drill" / "store"), clock=clk)
    rt.setup()
    sys_prompt = [11, 12, 13, 14, 15, 16, 17, 18, 21, 22, 23, 24, 25, 26, 27, 28]
    drill_prompts = {f"q{i}": sys_prompt + [31 + i] for i in range(6)}
    rq_path = str(root / "drill" / "requests.sqlite")
    drq = DurableQueue(rq_path, default_visibility=240.0, max_receive_count=6, clock=clk)
    drq.send_batch([{"uid": u, "prompt": p, "max_new_tokens": 12}
                    for u, p in drill_prompts.items()])
    rt.submit_job(JobFile(shared=dict(DS_DRILL, request_queue=rq_path, expected_requests=6,
                                      output_prefix="serve/drill", stream_slice_ticks=2,
                                      stream_idle_polls=8, request_visibility=240.0,
                                      request_max_receive_count=6),
                          groups=[{}, {}]))
    rt.start_cluster(FleetFile(startup_seconds=DS_TICK, market_seed=7))
    chaos = ChaosMonkey.revocation_drill(rt.fleet, clk, seed=1234, n_revocations=1,
                                         start=3 * DS_TICK, spacing=2 * DS_TICK,
                                         notice_seconds=2 * DS_TICK, store=rt.store,
                                         logs=rt.logs)
    reset_launches()
    summary = SimRunner(rt, tick_seconds=DS_TICK, chaos=chaos).run(max_ticks=300)
    launches = read_launches()
    total = add_launches(total, launches)
    counts = drq.counts()
    drq.close()
    served = {info.key.rsplit("/", 1)[-1][:-len(".json")]: rt.store.get_json(info.key)
              for info in rt.store.list("serve/drill/requests/")}
    drill_model = serve._cached_model(DS_DRILL)
    whole = ServeEngine(drill_model, serve._seed_params(DS_DRILL, drill_model, 0,
                                                        torch.device("cuda")),
                        device="cuda", max_batch=2, max_len=32, prefill_chunk=4,
                        cache_mode="paged", page_size=8)
    whole.submit([Request(uid=u, prompt=p, max_new_tokens=12) for u, p in drill_prompts.items()])
    want = {r.uid: r.output for r in whole.run_to_completion()}
    del whole
    got = {u: r["completion"] for u, r in served.items()}
    drill_counters = {c: ds_lease_counter(rt.store, "serve/drill/", c)
                      for c in ("revocation_notices", "drain_requeued_requests",
                                "requests_resumed", "checkpoints_published",
                                "checkpoint_resumes", "tokens_recovered")}
    # one completion record per request, every message acked, none dead
    require(counts == {"visible": 0, "in_flight": 0, "dead": 0} and sorted(got) == sorted(want),
            f"ds_parity drill: queue ends {counts}, served {sorted(got)}")
    require(drill_counters["revocation_notices"] >= 1 and drill_counters["checkpoint_resumes"] > 0,
            f"ds_parity drill: no checkpoint resume {drill_counters}")
    divs = ds_compare_greedy(drill_model, got, want, drill_prompts, "ds_parity drill")
    require(launches["paged_attention"] * (2 * L + 1) == launches["rmsnorm"] * L
            and launches["paged_attention"] > 0,
            f"ds_parity drill: launches {launches} are not 12 paged and 25 RMSNorm a dispatch")
    rec["runs"]["revocation_drill"] = {
        "tokens_equal_uninterrupted": not divs, "divergences": divs, "queue": counts,
        "counters": drill_counters, "chaos": [[c.kind, c.target, c.time] for c in chaos.log],
        "summary": {k: getattr(summary, k) for k in ("jobs_done", "preemptions", "ticks")},
        "launches": launches, "wall_s": time.perf_counter() - t0}
    serve.reset_serve_state()

    # -- a static mamba2-1.3b serve job (dense cache) against a direct engine, at
    # DS_SSM_LAYERS of its 48 layers (full width)
    ssm_job = {"arch": SSM_ARCH, "arch_overrides": {"n_layers": DS_SSM_LAYERS},
               "max_new_tokens": 16, "max_batch": 4, "max_len": 128, "prefill_chunk": 16,
               "cache_mode": "dense"}
    ssm_cfg = serve._cached_model(ssm_job).cfg
    ssm_reqs = parity_requests(ssm_cfg.vocab_size)[:4]
    t0 = time.perf_counter()
    reset_launches()
    store = ds_commands(root / "serve_ssm", "DSMamba", {"payload": "distributed-serve"},
                        {**ssm_job, "groups": [{"prompts": [r.prompt for r in ssm_reqs],
                                                "output_prefix": "serve/ssm"}]})
    launches = read_launches()
    total = add_launches(total, launches)
    res = store.get_json("serve/ssm/RESULTS.json")
    ssm_model = serve._cached_model(ssm_job)
    eng = ServeEngine(ssm_model, serve._seed_params(ssm_job, ssm_model, 0, torch.device("cuda")),
                      device="cuda", max_batch=4, max_len=128, prefill_chunk=16,
                      cache_mode="dense")
    eng.submit([Request(uid=f"req{i}", prompt=r.prompt, max_new_tokens=16)
                for i, r in enumerate(ssm_reqs)])
    want = {r.uid: r.output for r in eng.run_to_completion()}
    require(ds_completions(res) == want, "ds_parity mamba2: completions differ from a direct "
                                         "engine on the card")
    counters = {c: [res[c], getattr(eng, c)] for c in PARITY_COUNTERS}
    require(all(a == b for a, b in counters.values()),
            f"ds_parity mamba2: counters differ from a direct engine: {counters}")
    Ls, d, pd = ssm_cfg.n_layers, res["dispatches"], res["prefill_dispatches"]
    require(launches["ssd"] == Ls * pd and launches["rmsnorm"] == (Ls + 1) * d,
            f"ds_parity mamba2: launches {launches} for {pd} prefill / {d} dispatches, want "
            f"{Ls} SSD a prefill dispatch and {Ls + 1} RMSNorm a dispatch")
    rec["runs"]["serve_mamba2"] = {"tokens_equal": True, "counters": counters,
                                   "ssd_per_prefill_dispatch": launches["ssd"] / pd,
                                   "launches": launches, "wall_s": time.perf_counter() - t0}
    del eng
    serve._MODEL_CACHE.clear()
    serve._PARAM_CACHE.clear()
    release_device_memory()
    rec["launches"] = total
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


class LeaseTimers:
    """Wall time of one serving lease by layer, inside its thread: the
    queue (``DurableQueue`` methods: each one sqlite transaction), the
    object store (``ObjectStore`` methods), the engine's setup (building
    it and submitting requests, which sizes and grows the page pool), the
    engine's stepping (``ServeEngine`` and ``RequestScheduler`` methods
    the lease calls) and the rest (the lease loop's own Python).  Each category's time is exclusive: a queue
    call inside an engine call (the heartbeat's lease extension) counts as
    queue time only.  Transactions count the outermost queue calls."""

    def __init__(self):
        from repro_torch.core.queue import DurableQueue
        from repro_torch.core.storage import ObjectStore
        from repro_torch.serving.engine import ServeEngine
        from repro_torch.serving.scheduler import RequestScheduler

        self.targets = [
            ("queue", DurableQueue, ("__init__", "send", "send_batch", "receive",
                                     "receive_batch", "delete", "delete_batch",
                                     "change_visibility", "release", "counts", "close")),
            ("store", ObjectStore, ("put_bytes", "put_text", "put_json", "get_bytes", "get_text",
                                    "get_json", "exists", "head", "list", "delete")),
            ("engine_setup", ServeEngine, ("__init__", "submit", "submit_resume")),
            ("engine", ServeEngine, ("step", "checkpoint_slot", "snapshot")),
            ("engine", RequestScheduler, ("drain_finished", "trim_samples", "timing",
                                          "sample_marks")),
        ]
        self.seconds = {"queue": 0.0, "store": 0.0, "engine_setup": 0.0, "engine": 0.0}
        self.calls = dict.fromkeys(self.seconds, 0)
        self.thread = None
        self._stack: list = []  # [category, time of nested timed calls]
        self._saved: list = []

    def _wrap(self, cat: str, name: str, fn):
        import threading

        def timed(*args, **kwargs):
            if threading.get_ident() != self.thread:
                return fn(*args, **kwargs)
            outer = [c for c, _ in self._stack]
            self._stack.append([cat, 0.0])
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                return iter(list(out)) if name == "list" else out
            finally:
                elapsed = time.perf_counter() - t0
                _, inner = self._stack.pop()
                self.seconds[cat] += elapsed - inner
                if cat not in outer:
                    self.calls[cat] += 1
                if self._stack:
                    self._stack[-1][1] += elapsed

        return timed

    def __enter__(self):
        for cat, cls, names in self.targets:
            for name in names:
                fn = cls.__dict__[name]
                self._saved.append((cls, name, fn))
                setattr(cls, name, self._wrap(cat, name, fn))
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)

    def split(self, wall_s: float, ticks: int) -> dict:
        secs = dict(self.seconds, other=wall_s - sum(self.seconds.values()))
        return {"wall_s": wall_s, "seconds": secs,
                "share": {k: v / wall_s for k, v in secs.items()},
                "queue_transactions": self.calls["queue"],
                "store_operations": self.calls["store"], "engine_ticks": ticks,
                "queue_transactions_per_tick": self.calls["queue"] / max(1, ticks)}


def profile_top(prof, n: int = 10) -> list:
    """The functions with the most self time in a cProfile."""
    import pstats

    rows = sorted(((tt, nc, f"{Path(key[0]).name}:{key[1]}:{key[2]}")
                   for key, (_, nc, tt, _, _) in pstats.Stats(prof).stats.items()),
                  reverse=True)[:n]
    return [f"{name} {tt * 1e3:.1f} ms in {nc} calls" for tt, nc, name in rows]


class LeaseProbe:
    """Stands in for the ``distributed-serve`` payload around one run:
    records each call's start and end (a lease's wall time, in its worker
    thread) and, for a single lease, times its layers with
    :class:`LeaseTimers` (``layers``) or runs it under cProfile
    (``profile``)."""

    def __init__(self, *, layers: bool = False, profile: bool = False):
        from repro_torch.core.worker import PAYLOAD_REGISTRY

        self.registry, self.profile = PAYLOAD_REGISTRY, profile
        self.payload = PAYLOAD_REGISTRY["distributed-serve"]
        self.timers = LeaseTimers() if layers else None
        self.spans, self.wall_s, self.prof = [], [], None

    def __call__(self, job, ctx):
        import cProfile
        import threading

        prof = cProfile.Profile() if self.profile else None
        if self.timers is not None:
            self.timers.thread = threading.get_ident()
        t0 = time.perf_counter()
        if prof is not None:
            prof.enable()
        try:
            return self.payload(job, ctx)
        finally:
            if prof is not None:
                prof.disable()
                self.prof = prof
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            self.spans.append((t0, t1))
            self.wall_s.append(t1 - t0)

    def __enter__(self):
        self.registry["distributed-serve"] = self
        if self.timers is not None:
            self.timers.__enter__()
        return self

    def __exit__(self, *exc):
        if self.timers is not None:
            self.timers.__exit__(*exc)
        self.registry["distributed-serve"] = self.payload


class GcClock:
    """Seconds the cyclic garbage collector ran during a block (every
    thread), from ``gc.callbacks``, and its collections by generation."""

    def __enter__(self):
        import gc

        self.seconds, self.collections, self._t0 = 0.0, [0, 0, 0], 0.0
        gc.callbacks.append(self._callback)
        return self

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.collections[info["generation"]] += 1

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._callback)

    def record(self) -> dict:
        return {"gc_s": self.seconds, "gc_collections_by_generation": self.collections}


def stop_process(pid: int, grace_s: float = 10.0):
    """Reap a child that ends within ``grace_s`` (its exit status), or kill
    it; ``None`` when something else reaped it first."""
    import os
    import signal

    deadline = time.time() + grace_s
    try:
        while time.time() < deadline:
            done, status = os.waitpid(pid, os.WNOHANG)
            if done:
                return status
            time.sleep(0.2)
        os.kill(pid, signal.SIGKILL)
        return os.waitpid(pid, 0)[1]
    except ChildProcessError:
        return None


def phase_ds_serve(root: Path) -> dict:
    """``serve``'s 32 requests in bf16 at ``serve``'s knobs, in one call:
    the bare engine (its requests submitted at once, and one by one as a
    lease submits them), the lease payload called directly on this thread
    (no runner: the lease loop's own cost), and one streaming lease
    through the four commands in the foreground (a worker thread beside
    the runner's monitor loop), in turns (bare, bare one by one, direct,
    lease, lease under cProfile, then the four again; each unprofiled
    lease's wall time split by :class:`LeaseTimers`, the profiled one's
    top self-time functions; the garbage collector's time in each run),
    and the paper's detached flow (``startCluster`` spawns the worker host,
    ``monitor`` polls until the queue drains, the host's
    ``summary/<app>.json``).  Gates: every request served and acked, and
    the detached completions equal the foreground's."""
    import contextlib
    import io
    import os
    import threading

    from repro_torch.core import LogGroup, MetricRegistry, WallClock, WorkerContext
    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch import run_ds, serve
    from repro_torch.serving.engine import Request, ServeEngine

    t_phase = time.perf_counter()
    job = {"arch": "ds-paper-100m", "arch_overrides": {"n_layers": DS_SERVE_LAYERS},
           "dtype": "bfloat16", "max_new_tokens": 64, "max_batch": 16, "max_len": 640,
           "prefill_chunk": 16, "cache_mode": "paged", "page_size": 16}
    cfg = serve._cached_model(job).cfg
    L = cfg.n_layers
    kw = dict(max_batch=16, max_len=640, prefill_chunk=16, page_size=16, cache_mode="paged")
    reqs = serve_requests(cfg.vocab_size)
    bodies = [{"uid": r.uid, "prompt": r.prompt, "max_new_tokens": 64} for r in reqs]
    model = serve._cached_model(job)
    params = serve._seed_params(job, model, 0, torch.device("cuda"))
    warm = [Request(uid=f"w{i}", prompt=list(range(1, 40 + i)), max_new_tokens=4)
            for i in range(2)]
    run_engine(model, params, warm, "cuda", **kw)
    lease = {**job, "expected_requests": len(reqs), "stream_idle_polls": 200}
    rec = {"phase": "ds_serve", "arch": cfg.name, "dtype": "bfloat16", "requests": len(reqs),
           "max_new_tokens": 64, "max_batch": 16, "nvidia_smi": smi_line(),
           "bare_engine": [], "bare_one_by_one": [], "direct": [], "foreground": []}
    outputs = {}

    def bare_run(one_by_one: bool) -> dict:
        eng = ServeEngine(model, params, device="cuda", **kw)
        for batch in ([[r] for r in serve_requests(cfg.vocab_size)] if one_by_one
                      else [serve_requests(cfg.vocab_size)]):
            eng.submit(batch)
        release_device_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with GcClock() as gc_clock:
            eng.run_to_completion()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outputs["bare_one_by_one" if one_by_one else "bare"] = {
            r.uid: r.output for r in eng.finished}
        return {"wall_s": wall, "tokens": eng.tokens_emitted,
                "tokens_per_s": eng.tokens_emitted / wall, "ticks": eng.stats.ticks,
                "dispatches": eng.dispatches, "total_pages": eng.n_pages,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                **gc_clock.record()}

    def direct_run(name: str) -> tuple:
        rq = ds_request_queue(root / f"{name}_requests.sqlite", bodies)
        store = ObjectStore(str(root / name / "store"))
        ctx = WorkerContext(store=store, logs=LogGroup(name), metrics=MetricRegistry(),
                            clock=WallClock(), task=None, worker_id=name)
        release_device_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        timers = LeaseTimers()
        timers.thread = threading.get_ident()
        t0 = time.perf_counter()
        with GcClock() as gc_clock, timers:
            serve.serve_payload({**lease, "request_queue": rq, "output_prefix": "serve/lease"},
                                ctx)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        res = store.get_json("serve/lease/RESULTS.json")
        counts = ds_queue_counts(rq)
        require(len(res["requests"]) == len(reqs) and counts == {"visible": 0, "in_flight": 0,
                                                                  "dead": 0},
                f"ds_serve {name}: {len(res['requests'])} served, request queue ends {counts}")
        d = res["dispatches"]
        require(launches["paged_attention"] == L * d and launches["rmsnorm"] == (2 * L + 1) * d,
                f"ds_serve {name}: launches {launches} for {d} dispatches")
        outputs[name] = ds_completions(res)
        return {"wall_s": wall, "tokens": res["tokens_emitted"],
                "tokens_per_s": res["tokens_emitted"] / wall, "ticks": res["ticks"],
                "dispatches": d, "total_pages": res["total_pages"],
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                "split": timers.split(wall, res["ticks"]), **gc_clock.record()}, launches

    def lease_run(name: str, profile: bool) -> tuple:
        rq = ds_request_queue(root / f"{name}_requests.sqlite", bodies)
        release_device_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with LeaseProbe(layers=not profile, profile=profile) as probe, GcClock() as gc_clock:
            store = ds_commands(root / name, f"DS{name.title()}",
                                {"payload": "distributed-serve"},
                                {**lease, "groups": [{"request_queue": rq,
                                                      "output_prefix": "serve/lease"}]})
        commands_s = time.perf_counter() - t0
        launches = read_launches()
        res = store.get_json("serve/lease/RESULTS.json")
        counts = ds_queue_counts(rq)
        require(len(res["requests"]) == len(reqs) and counts == {"visible": 0, "in_flight": 0,
                                                                  "dead": 0},
                f"ds_serve {name}: {len(res['requests'])} served, request queue ends {counts}")
        d = res["dispatches"]
        require(launches["paged_attention"] == L * d and launches["rmsnorm"] == (2 * L + 1) * d,
                f"ds_serve {name}: launches {launches} for {d} dispatches")
        lease_s = probe.wall_s[0]
        outputs[name] = ds_completions(res)
        run = {"lease_wall_s": lease_s, "commands_wall_s": commands_s,
               "tokens": res["tokens_emitted"], "tokens_per_s": res["tokens_emitted"] / lease_s,
               "ticks": res["ticks"], "dispatches": d, "total_pages": res["total_pages"],
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "queue": counts, "launches": launches, **gc_clock.record()}
        if profile:
            run["top_self_time"] = profile_top(probe.prof)
        else:
            run["split"] = probe.timers.split(lease_s, res["ticks"])
        return run, launches

    total: dict = {}
    for name in ("bare", "bare_one_by_one", "direct", "foreground", "profiled",
                 "bare", "bare_one_by_one", "direct2", "foreground2"):
        if name.startswith("bare"):
            one_by_one = name == "bare_one_by_one"
            rec["bare_one_by_one" if one_by_one else "bare_engine"].append(bare_run(one_by_one))
            continue
        if name.startswith("direct"):
            run, launches = direct_run(name)
            rec["direct"].append(run)
        elif name == "profiled":
            rec["profiled"], launches = lease_run(name, True)
        else:
            run, launches = lease_run(name, False)
            rec["foreground"].append(run)
        total = add_launches(total, launches)
    fg = outputs["foreground"]
    require(all(outputs[n] == fg for n in ("foreground2", "profiled", "direct", "direct2")),
            "ds_serve: the leases' completions differ between runs")
    rec["bare_one_by_one_equals_bare"] = outputs["bare_one_by_one"] == outputs["bare"]

    def mean_tps(runs):
        return sum(r["tokens_per_s"] for r in runs) / len(runs)

    rec["one_by_one_over_bare_tokens_per_s"] = (mean_tps(rec["bare_one_by_one"])
                                                 / mean_tps(rec["bare_engine"]))
    rec["direct_over_bare_tokens_per_s"] = mean_tps(rec["direct"]) / mean_tps(rec["bare_engine"])
    rec["lease_over_direct_tokens_per_s"] = mean_tps(rec["foreground"]) / mean_tps(rec["direct"])
    rec["lease_over_bare_tokens_per_s"] = mean_tps(rec["foreground"]) / mean_tps(rec["bare_engine"])
    rec["foreground_vs_bare_tokens_equal"] = fg == outputs["bare"]  # reported, not gated

    # the paper's detached flow: the worker host is a second process
    workdir = root / "detached"
    rq = ds_request_queue(root / "detached_requests.sqlite", bodies)
    src = str(ROOT / "src")
    os.environ["PYTHONPATH"] = os.pathsep.join([src, *filter(None, [os.environ.get(
        "PYTHONPATH")])])
    t0 = time.perf_counter()
    ds_commands(workdir, "DSDetached", {"payload": "distributed-serve"},
                {**lease, "groups": [{"request_queue": rq, "output_prefix": "serve/lease"}]},
                foreground=False)
    pid = int((workdir / "wd" / "worker_host.pid").read_text())
    monitor_out = io.StringIO()
    store = ObjectStore(str(workdir / "wd" / "store"))
    try:
        with contextlib.redirect_stdout(monitor_out):
            require(run_ds.main(["--workdir", str(workdir / "wd"), "monitor", "--poll",
                                 "0.5"]) == 0, "ds_serve detached: monitor failed")
        monitor_s = time.perf_counter() - t0
        deadline = time.time() + 300
        while not store.exists("summary/DSDetached.json") and time.time() < deadline:
            time.sleep(0.2)
        summary_s = time.perf_counter() - t0
    finally:
        status = stop_process(pid)
    require(store.exists("summary/DSDetached.json"),
            "ds_serve detached: the worker host wrote no summary within 300 s")
    summary = store.get_json("summary/DSDetached.json")
    res = store.get_json("serve/lease/RESULTS.json")
    counts = ds_queue_counts(rq)
    require(summary["jobs_done"] == 1 and len(res["requests"]) == len(reqs)
            and counts == {"visible": 0, "in_flight": 0, "dead": 0},
            f"ds_serve detached: summary {summary}, {len(res['requests'])} served, request "
            f"queue ends {counts}")
    require(ds_completions(res) == fg,
            "ds_serve detached: completions differ from the foreground lease's")
    rec["detached"] = {"tokens": res["tokens_emitted"], "summary": summary,
                       "start_to_drained_s": monitor_s, "start_to_summary_s": summary_s,
                       "tokens_per_s_start_to_summary": res["tokens_emitted"] / summary_s,
                       "worker_host_exit_status": status, "queue": counts,
                       "monitor_lines": len(monitor_out.getvalue().splitlines()),
                       "completions_equal_foreground": True}
    rec["launches"] = total
    serve.reset_serve_state()
    serve._MODEL_CACHE.clear()
    serve._PARAM_CACHE.clear()
    release_device_memory()
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


# ------------------------------------------------------------------ the prefix store
DS_STORE_F32 = {**DS_SERVE_F32, "prefix_store": True, "prefix_store_namespace": "ds_store/f32"}
DS_STORE_BF16 = {"arch": "ds-paper-100m", "arch_overrides": {"n_layers": DS_SERVE_LAYERS},
                 "dtype": "bfloat16", "max_new_tokens": 64,
                 "max_batch": 16, "max_len": 896, "prefill_chunk": 16, "cache_mode": "paged",
                 "page_size": 16, "prefix_store": True, "prefix_store_namespace": "ds_store/bf16"}
STORE_COUNTERS = ("prefix_store_pages_published", "prefix_store_pages_hydrated",
                  "prefix_store_tokens_hydrated", "prompt_tokens_skipped",
                  "prompt_tokens_ingested", "hydration_fetch_ops", "prefix_store_bytes_fetched",
                  "prefix_store_hash_mismatches", "dispatches", "prefill_dispatches",
                  "decode_dispatches", "tokens_emitted")
EMPTY_QUEUE = {"visible": 0, "in_flight": 0, "dead": 0}


def ds_sim(root: Path, app: str, shared: dict, groups: list, *, machines: int,
           queues: dict = None, clock=None):
    """One job file through the runtime's commands on the ``SimRunner``
    (setup, submit, start the fleet, run to the drain).  ``queues`` maps
    request-queue paths to the bodies sent there first; every queue is
    opened on the run's virtual clock (``clock``, to go on from an earlier
    run), whose times its messages carry.  Returns the runtime and each
    queue's counts after the run."""
    from repro_torch.core import DSConfig, DSRuntime, FleetFile, JobFile, SimRunner, VirtualClock
    from repro_torch.core.queue import DurableQueue
    from repro_torch.launch import serve

    serve.reset_serve_state()
    clk = clock or VirtualClock()
    opened = {}
    for path, bodies in (queues or {}).items():
        opened[path] = DurableQueue(path, default_visibility=240.0, clock=clk)
        if bodies:
            opened[path].send_batch(bodies)
    rt = DSRuntime(DSConfig(app_name=app, payload="distributed-serve",
                            cluster_machines=machines, tasks_per_machine=1,
                            machine_type=["sim.large"], machine_price=1.0,
                            sqs_message_visibility=240.0, check_if_done=False,
                            monitor_poll_seconds=DS_TICK),
                   store_root=str(root / "store"), clock=clk)
    rt.setup()
    rt.submit_job(JobFile(shared=dict(shared), groups=groups))
    rt.start_cluster(FleetFile(startup_seconds=0.0))
    summary = SimRunner(rt, tick_seconds=DS_TICK).run(max_ticks=2000)
    require(summary.jobs_done == len(groups), f"{app}: {summary}")
    counts = {}
    for path, q in opened.items():
        counts[path] = q.counts()
        q.close()
    return rt, counts


def chain_keys(ps, prompt: list, page: int) -> list:
    """The content keys of a prompt's full chunks and its sub-page tail."""
    keys, key = [], ps.root_key()
    for j in range(len(prompt) // page):
        key = ps.child_key(key, prompt[j * page:(j + 1) * page])
        keys.append(key)
    tail = prompt[len(prompt) // page * page:]
    if tail:
        keys.append(ps.child_key(keys[-1] if keys else ps.root_key(), tail))
    return keys


class PageAudit:
    """Holds every hydrated page against the page the publisher's pool
    held: records each page the publisher pulls (the host copy taken at
    submit time, by content key) and, after each hydration write, requires
    the written pool page to equal it bit for bit (``torch.equal`` on the
    integer view)."""

    def __init__(self):
        from repro_torch.serving.cache_manager import KVCacheManager
        from repro_torch.serving.prefix_store import AsyncPublisher, PrefixStore

        self.targets = ((AsyncPublisher, "submit", self._submit),
                        (PrefixStore, "fetch", self._fetch),
                        (KVCacheManager, "_write_page", self._write))
        self.published, self.saved = {}, []
        self.last_key, self.checked = None, 0

    def _submit(self, orig):
        audit = self

        def submit(self, key, arrays):
            if callable(arrays):
                thunk = arrays

                def arrays():
                    out = thunk()
                    audit.published[key] = {n: a.copy() for n, a in out.items()}
                    return out
            return orig(self, key, arrays)
        return submit

    def _fetch(self, orig):
        audit = self

        def fetch(self, key, like):
            audit.last_key = key
            return orig(self, key, like)
        return fetch

    def _write(self, orig):
        audit = self

        def write_page(self, pid, arrays):
            from repro_torch.serving.prefix_store import device_page

            orig(self, pid, arrays)
            want = audit.published.get(audit.last_key)
            require(want is not None, f"hydrated page {audit.last_key} was never published here")
            for name, leaf in self._pool_leaves().items():
                ref = device_page(want[name], leaf.dtype).to(leaf.device)
                ints = torch.int16 if leaf.dtype == torch.bfloat16 else torch.int32
                require(torch.equal(leaf[:, pid].view(ints), ref.view(ints)),
                        f"hydrated page {audit.last_key} ({name}) differs from the published one")
            audit.checked += 1
        return write_page

    def __enter__(self):
        for cls, name, wrap in self.targets:
            fn = cls.__dict__[name]
            self.saved.append((cls, name, fn))
            setattr(cls, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)


class StoreTimers:
    """Host time of the prefix store's work, by step: on the lease's thread
    the existence probes and pins, the device->host pulls of published
    pages, the fetches (get, unpack, digest and template checks), the
    host->device hydration writes and the waits for background writes at
    the drain seams; on the publisher's thread the npz pack and put of
    each page.  Each step's seconds and calls."""

    def __init__(self):
        from repro_torch.serving.cache_manager import KVCacheManager
        from repro_torch.serving.prefix_store import AsyncPublisher, PrefixStore

        self.targets = [*((PrefixStore, n) for n in ("exists", "pin", "fetch", "publish")),
                        (KVCacheManager, "_page_arrays"), (KVCacheManager, "_write_page"),
                        (AsyncPublisher, "flush")]
        self.seconds = {n: 0.0 for _, n in self.targets}
        self.calls = {n: 0 for _, n in self.targets}
        self.saved, self.thread = [], None

    def _wrap(self, name, fn):
        import threading

        def timed(*args, **kwargs):
            if name != "publish" and threading.get_ident() != self.thread:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
        return timed

    def __enter__(self):
        import threading

        self.thread = threading.get_ident()
        for cls, name in self.targets:
            fn = cls.__dict__[name]
            self.saved.append((cls, name, fn))
            setattr(cls, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)

    def record(self, wall_s: float) -> dict:
        s, c = self.seconds, self.calls
        lease_thread = sum(v for k, v in s.items() if k != "publish")
        return {
            "seconds": dict(s), "calls": dict(c),
            "ms_per_published_page": {
                "device_pull": 1e3 * s["_page_arrays"] / max(1, c["_page_arrays"]),
                "pack_put": 1e3 * s["publish"] / max(1, c["publish"])},
            "ms_per_hydrated_page": {
                "get_unpack": 1e3 * s["fetch"] / max(1, c["fetch"]),
                "copy_to_device": 1e3 * s["_write_page"] / max(1, c["_write_page"])},
            "lease_thread_store_s": lease_thread,
            "store_share_of_lease_wall": lease_thread / wall_s,
            "background_pack_put_s": s["publish"]}


def phase_ds_store(root: Path, plain: dict) -> dict:
    """The cross-host prefix store and disaggregated prefill/decode leases on
    the card, full-width ds-paper-100m from seed 0, page size 16.

    f32 gates, through the runtime on the ``SimRunner``: two static jobs
    sharing a 32-token system prompt (one worker publishes its 2 pages, the
    other hydrates them; tokens equal a card engine without a store,
    counters equal the same scenario on the CPU); a prefill lease and a
    decode lease over ``parity``'s 6 requests joined by a decode queue
    (6 handoffs published and admitted, no fallback, the prefill side
    emits nothing, decode tokens equal ``parity``'s card engine, both
    queues empty); the same split with one published page truncated by the
    chaos monkey between the two leases (the miss counted, one fallback,
    tokens still equal).  Every dispatch of every run launches 12 paged and
    25 RMSNorm kernels; every hydrated page equals the publisher's pool
    page bit for bit (:class:`PageAudit`).

    bf16 numbers: ``serve``'s 32 requests behind one shared 256-token
    system prompt, 64 new tokens, ``max_batch`` 16, through the lease
    payload called directly, in turns: one unified lease with the store,
    then a prefill lease followed by a decode lease; tokens/s, pages and
    bytes published and hydrated, host ms per page by step and the store's
    share of each lease's wall time (:class:`StoreTimers`), peak memory;
    the split's tokens against the unified lease's (reported, not gated:
    the decode worker re-dispatches each frontier token alone in a chunk,
    where the unified lease samples it from a prompt chunk's last row)."""
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.core import LogGroup, MetricRegistry, WallClock, WorkerContext
    from repro_torch.core.chaos import ChaosEvent, ChaosMonkey
    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch import serve
    from repro_torch.serving.engine import Request
    from repro_torch.serving.prefix_store import PrefixStore

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = get_arch("ds-paper-100m")
    L, ps = cfg.n_layers, DS_STORE_F32["page_size"]
    rec = {"phase": "ds_store", "arch": cfg.name, "page_size": ps, "nvidia_smi": smi_line(),
           "f32": {}, "bf16": {"unified": [], "split": []}}
    total: dict = {}

    def gate_launches(what, launches, dispatches, L=L):
        require(launches["paged_attention"] == L * dispatches
                and launches["rmsnorm"] == (2 * L + 1) * dispatches,
                f"ds_store {what}: launches {launches} for {dispatches} dispatches, want {L} "
                f"paged and {2 * L + 1} RMSNorm a dispatch")
        return {k: v for k, v in launches.items() if v}

    # -- f32: two static jobs sharing a 32-token system prompt
    rng = np.random.default_rng(3)
    sys_prompt = rng.integers(1, cfg.vocab_size, 32).tolist()
    jobs = [[sys_prompt + rng.integers(1, cfg.vocab_size, n).tolist() for n in (3, 9)]
            for _ in range(2)]
    share = {**DS_STORE_F32, "max_new_tokens": 8}
    groups = [{"prompts": p, "output_prefix": f"serve/w{i}"} for i, p in enumerate(jobs)]
    results = {}
    for device in ("cuda", "cpu"):
        reset_launches()
        t0 = time.perf_counter()
        rt, _ = ds_sim(root / f"share_{device}", "DSShare", {**share, "device": device},
                       [dict(g) for g in groups], machines=2)
        results[device] = [rt.store.get_json(f"serve/w{i}/RESULTS.json") for i in range(2)]
        if device == "cuda":
            launches, share_s = read_launches(), time.perf_counter() - t0
    card, cpu = results["cuda"], results["cpu"]
    counters = {c: [[r[c] for r in card], [r[c] for r in cpu]] for c in STORE_COUNTERS}
    require(all(a == b for a, b in counters.values()),
            f"ds_store share: card counters differ from the CPU's: {counters}")
    pubs = [r["prefix_store_pages_published"] for r in card]
    hyds = [r["prefix_store_pages_hydrated"] for r in card]
    require(sorted(pubs) == [0, 2] and sorted(hyds) == [0, 2] and pubs.index(2) != hyds.index(2),
            f"ds_store share: published {pubs}, hydrated {hyds}: want one worker to publish "
            "2 pages and the other to hydrate them")
    model = serve._cached_model(share)
    params = serve._seed_params(share, model, 0, torch.device("cuda"))
    divs = []
    for i, prompts in enumerate(jobs):
        eng, _ = run_engine(model, params, [Request(uid=f"req{j}", prompt=p, max_new_tokens=8)
                                            for j, p in enumerate(prompts)],
                            "cuda", max_batch=4, max_len=128, prefill_chunk=16,
                            cache_mode="paged", page_size=ps)
        want = {r.uid: r.output for r in eng.finished}
        divs += ds_compare_greedy(model, ds_completions(card[i]), want,
                                  {r.uid: r.prompt for r in eng.finished},
                                  f"ds_store share w{i}")
        del eng
    total = add_launches(total, launches)
    rec["f32"]["share"] = {
        "tokens_equal_engine_without_store": not divs, "divergences": divs,
        "counters_card_cpu": counters,
        "launches": gate_launches("share", launches, sum(r["dispatches"] for r in card)),
        "wall_s": share_s}

    # -- f32: a prefill lease and a decode lease over parity's 6 requests
    reqs = parity_requests(cfg.vocab_size)
    prompts = {r.uid: r.prompt for r in reqs}
    bodies = [{"uid": r.uid, "prompt": r.prompt, "max_new_tokens": 24} for r in reqs]
    card_tokens = {r.uid: r.output for r in plain["paged"].finished}
    lease = {**DS_STORE_F32, "stream_slice_ticks": 4, "stream_idle_polls": 200}

    def split_groups(base: Path) -> tuple:
        """The two leases' groups over a request queue and a decode queue."""
        rq, dq = str(base / "requests.sqlite"), str(base / "decode.sqlite")
        return ({"worker_role": "prefill", "request_queue": rq, "decode_queue": dq,
                 "expected_requests": 6, "output_prefix": "serve/dpre"},
                {"worker_role": "decode", "request_queue": dq, "expected_requests": 6,
                 "output_prefix": "serve/ddec"}, rq, dq)

    def split_result(what, store, queues, launches, wall_s, audit):
        got = {info.key.rsplit("/", 1)[-1][:-len(".json")]: store.get_json(info.key)["completion"]
               for info in store.list("serve/ddec/requests/")}
        ctr = {side: {c: ds_lease_counter(store, f"serve/{side}/", c)
                      for c in (*STORE_COUNTERS, "handoffs_published", "handoffs_admitted",
                                "handoff_fallbacks", "handoff_seal_rejects")}
               for side in ("dpre", "ddec")}
        require(sorted(got) == sorted(card_tokens) and all(q == EMPTY_QUEUE
                                                           for q in queues.values()),
                f"ds_store {what}: served {sorted(got)}, queues end {queues}")
        require(ctr["dpre"]["handoffs_published"] == 6 and ctr["ddec"]["handoffs_admitted"] == 6
                and ctr["dpre"]["tokens_emitted"] == 0,
                f"ds_store {what}: handoffs published {ctr['dpre']['handoffs_published']}, "
                f"admitted {ctr['ddec']['handoffs_admitted']}, prefill tokens "
                f"{ctr['dpre']['tokens_emitted']}")
        require(audit.checked == ctr["ddec"]["prefix_store_pages_hydrated"] > 0,
                f"ds_store {what}: {audit.checked} pages audited, "
                f"{ctr['ddec']['prefix_store_pages_hydrated']} hydrated")
        divs = ds_compare_greedy(model, got, card_tokens, prompts, f"ds_store {what}")
        d = ctr["dpre"]["dispatches"] + ctr["ddec"]["dispatches"]
        return {"tokens_equal_parity_card": not divs, "divergences": divs, "counters": ctr,
                "queues": queues, "pages_audited_bit_equal": audit.checked,
                "launches": gate_launches(what, launches, d), "wall_s": wall_s}

    pre_g, dec_g, rq, dq = split_groups(root / "split")
    reset_launches()
    t0 = time.perf_counter()
    with PageAudit() as audit:
        # one worker: the two permits take turns every 4 ticks (on two, a
        # permit that moves to the other worker strands the handoffs its
        # first holder claimed until their visibility runs out, in the
        # reference as in the port)
        rt, counts = ds_sim(root / "split", "DSSplit", lease, [pre_g, dec_g], machines=1,
                            queues={rq: bodies, dq: None})
    launches = read_launches()
    total = add_launches(total, launches)
    clean = split_result("split", rt.store, counts, launches, time.perf_counter() - t0, audit)
    require(clean["counters"]["ddec"]["handoff_fallbacks"] == 0,
            f"ds_store split: {clean['counters']['ddec']['handoff_fallbacks']} fallbacks")
    rec["f32"]["split"] = clean

    # -- f32: the split again, one published page truncated between the leases
    pre_g, dec_g, rq, dq = split_groups(root / "split_truncated")
    reset_launches()
    t0 = time.perf_counter()
    with PageAudit() as audit:
        rt, _ = ds_sim(root / "split_truncated", "DSSplitP", lease, [pre_g], machines=1,
                            queues={rq: bodies, dq: None})
        # a page in exactly one request's chain: p1's first chunk
        keys = sorted(i.key for i in rt.store.list("kvprefix/"))
        victim = chain_keys(PrefixStore(rt.store, DS_STORE_F32["prefix_store_namespace"]),
                            prompts["p1"], ps)[0]
        index = [k.rsplit("/", 1)[-1] for k in keys].index(victim)
        chaos = ChaosMonkey(rt.fleet, rt.clock, store=rt.store,
                            events=[ChaosEvent(kind="truncate_blob", at=0.0, victim=index)])
        require([r.kind for r in chaos.tick()] == ["truncate_blob"],
                "ds_store split_truncated: the chaos monkey truncated nothing")
        clock = rt.clock  # the decode queue's messages carry the first run's times
        rt, counts2 = ds_sim(root / "split_truncated", "DSSplitD", lease, [dec_g], machines=1,
                             queues={rq: None, dq: None}, clock=clock)
    launches = read_launches()
    total = add_launches(total, launches)
    trunc = split_result("split_truncated", rt.store, counts2, launches,
                         time.perf_counter() - t0, audit)
    dec = trunc["counters"]["ddec"]
    require(dec["handoff_fallbacks"] == 1
            and dec["hydration_fetch_ops"] > dec["prefix_store_pages_hydrated"],
            f"ds_store split_truncated: fallbacks {dec['handoff_fallbacks']}, fetches "
            f"{dec['hydration_fetch_ops']} for {dec['prefix_store_pages_hydrated']} hydrated")
    trunc["truncated_key"] = victim
    rec["f32"]["split_truncated"] = trunc
    serve._PARAM_CACHE.clear()

    # -- bf16 numbers: serve's 32 requests behind a shared 256-token system prompt
    job = DS_STORE_BF16
    sys_prompt = np.random.default_rng(4).integers(1, cfg.vocab_size, 256).tolist()
    bodies = [{"uid": r.uid, "prompt": sys_prompt + r.prompt, "max_new_tokens": 64}
              for r in serve_requests(cfg.vocab_size)]
    model = serve._cached_model(job)
    params = serve._seed_params(job, model, 0, torch.device("cuda"))
    run_engine(model, params, [Request(uid="w", prompt=list(range(1, 40)), max_new_tokens=4)],
               "cuda", max_batch=16, max_len=896, prefill_chunk=16, page_size=ps,
               cache_mode="paged")
    outputs = {}

    def lease_call(store, name, extra, n_expected):
        q = extra.get("request_queue")
        ctx = WorkerContext(store=store, logs=LogGroup(name), metrics=MetricRegistry(),
                            clock=WallClock(), task=None, worker_id=name)
        release_device_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        timers = StoreTimers()
        t0 = time.perf_counter()
        with timers:
            out = serve.serve_payload({**job, "expected_requests": n_expected,
                                       "stream_idle_polls": 200, **extra}, ctx)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        require(ds_queue_counts(q) == EMPTY_QUEUE, f"ds_store {name}: request queue not empty")
        snap = {c: out[c] for c in (*STORE_COUNTERS, "handoffs_published", "handoffs_admitted",
                                    "handoff_fallbacks")}
        run = {"wall_s": wall, "tokens": out["tokens_emitted"],
               "tokens_per_s": out["tokens_emitted"] / wall, "counters": snap,
               "store_bytes_after": sum(i.size for i in store.list("kvprefix/")),
               "page_bytes": out["page_bytes"], "total_pages": out["total_pages"],
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "store": timers.record(wall),
               "launches": gate_launches(name, launches, out["dispatches"], model.cfg.n_layers)}
        return run, launches

    for turn in range(2):
        t_root = root / f"bf16_{turn}"
        store = ObjectStore(str(t_root / "store"))
        rq = ds_request_queue(t_root / "unified.sqlite", bodies)
        run, launches = lease_call(store, f"unified{turn}",
                                   {"request_queue": rq, "output_prefix": "serve/unified"},
                                   len(bodies))
        total = add_launches(total, launches)
        outputs[f"unified{turn}"] = ds_completions(store.get_json("serve/unified/RESULTS.json"))
        rec["bf16"]["unified"].append(run)

        store = ObjectStore(str(t_root / "split_store"))
        rq = ds_request_queue(t_root / "split.sqlite", bodies)
        dq = str(t_root / "decode.sqlite")
        pre, launches = lease_call(store, f"prefill{turn}",
                                   {"worker_role": "prefill", "request_queue": rq,
                                    "decode_queue": dq, "output_prefix": "serve/pre"},
                                   len(bodies))
        total = add_launches(total, launches)
        dec, launches = lease_call(store, f"decode{turn}",
                                   {"worker_role": "decode", "request_queue": dq,
                                    "output_prefix": "serve/dec"}, len(bodies))
        total = add_launches(total, launches)
        require(pre["counters"]["handoffs_published"] == dec["counters"]["handoffs_admitted"]
                == len(bodies) and dec["counters"]["handoff_fallbacks"] == 0
                and pre["tokens"] == 0,
                f"ds_store bf16 split: prefill {pre['counters']}, decode {dec['counters']}")
        outputs[f"split{turn}"] = {
            info.key.rsplit("/", 1)[-1][:-len(".json")]: store.get_json(info.key)["completion"]
            for info in store.list("serve/dec/requests/")}
        shutil.rmtree(t_root)  # ~1 GB of pages a turn
        wall = pre["wall_s"] + dec["wall_s"]
        rec["bf16"]["split"].append({
            "prefill": pre, "decode": dec, "wall_s": wall, "tokens": dec["tokens"],
            "tokens_per_s_start_to_summary": dec["tokens"] / wall,
            "bytes_hydrated": dec["counters"]["prefix_store_bytes_fetched"]})
    require(outputs["unified0"] == outputs["unified1"] and outputs["split0"] == outputs["split1"],
            "ds_store bf16: a lease's completions differ between turns")
    differ = sorted(u for u in outputs["unified0"] if outputs["unified0"][u] != outputs["split0"][u])
    rec["bf16"]["split_vs_unified_tokens_equal"] = not differ  # reported, not gated
    rec["bf16"]["split_vs_unified_requests_differing"] = len(differ)
    rec["launches"] = total
    serve.reset_serve_state()
    serve._MODEL_CACHE.clear()
    serve._PARAM_CACHE.clear()
    release_device_memory()
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


# ------------------------------------------------------------------ the SSM family
SSM_ARCH = "mamba2-1.3b"


def ssm_weights():
    """Full-width mamba2-1.3b weights from seed 0, drawn once on the host
    in f32 and reused by every SSM phase (cast or moved as each needs)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.tree import tree_leaves

    cfg = get_arch(SSM_ARCH)
    t0 = time.perf_counter()
    params = Model(cfg, ModelRuntime(dtype=torch.float32)).init(0, device="cpu")
    emit({"phase": "ssm_weights", "arch": cfg.name, "layers": cfg.n_layers,
          "seconds": time.perf_counter() - t0,
          "parameters": sum(t.numel() for t in tree_leaves(params))})
    return cfg, params


_HOST_DRAWS: dict = {}


def init_params(model, seed: int, device):
    """``model.init(seed, device)``, bit for bit: the numpy draw is made once
    a (config, seed) on the host in f32, kept, and copied to ``device`` in
    the model's dtype at each call (several phases start from the same
    seed-0 weights; ``Model.init`` draws them in f32 and casts alike)."""
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.models.weights import FP32_PARAMS
    from repro_torch.tree import tree_map_with_path

    key = (model.cfg, seed)
    if key not in _HOST_DRAWS:
        _HOST_DRAWS[key] = Model(model.cfg, ModelRuntime(dtype=torch.float32)).init(
            seed, device="cpu")
    return tree_map_with_path(
        lambda path, t: t.to(device=device, copy=True,
                             dtype=torch.float32 if path[-1] in FP32_PARAMS else model.rt.dtype),
        _HOST_DRAWS[key])


def cast_params(params, dtype, device):
    """The tree on ``device`` in ``dtype``, the SSM's A_log, D and dt_bias
    and a MoE's router kept float32 (as in the reference and
    ``Model.init``)."""
    from repro_torch.models.weights import FP32_PARAMS
    from repro_torch.tree import tree_map_with_path

    return tree_map_with_path(
        lambda path, t: t.to(device=device,
                             dtype=torch.float32 if path[-1] in FP32_PARAMS else dtype),
        params)


def first_layers(cfg, params, n: int) -> tuple:
    """The model cut to its first ``n`` layers: the config and the tree
    (a hybrid's stacked LoRA cut to the invocations those layers run)."""
    import dataclasses

    cfg = dataclasses.replace(cfg, n_layers=n)
    params = {**params, "layers": params["layers"][:n]}
    if "lora_a" in params.get("shared", {}):
        n_inv, shared = n // cfg.shared_attn_every, params["shared"]
        params["shared"] = {**shared, "lora_a": shared["lora_a"][:n_inv],
                            "lora_b": shared["lora_b"][:n_inv]}
    return cfg, params


# The first 4 of mamba2-1.3b's 48 layers (6 before the roofline phase):
# the depth cut keeps the CPU side short and pays for the later phases;
# ssm_serve runs 6, ssm_eval all 48.
SSM_PARITY_LAYERS = 4
SSM_SERVE_LAYERS = 6


def phase_ssm_parity(cfg, params_cpu) -> dict:
    """Full-width mamba2-1.3b in f32 from seed 0, the first
    ``SSM_PARITY_LAYERS`` of its layers: the dense-cache engine on the card
    (SSD kernel at prefill, RMSNorm) against the same engine on the CPU
    (plain path): equal greedy tokens (the near-tie exception of
    ``phase_parity``) and counters; an SSD launch a layer a prefill
    dispatch, none a decode dispatch, an RMSNorm a layer and ``ln_f`` a
    dispatch.  ``hybrid_parity`` runs 38 full-width mamba2 layers so."""
    from repro_torch.models import Model, ModelRuntime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params_cpu = first_layers(cfg, params_cpu, SSM_PARITY_LAYERS)
    model = Model(cfg, ModelRuntime(dtype=torch.float32))
    kw = dict(max_batch=4, max_len=128, prefill_chunk=16, cache_mode="dense")
    params_gpu = cast_params(params_cpu, torch.float32, "cuda")
    reset_launches()
    gpu, gpu_s = run_engine(model, params_gpu, parity_requests(cfg.vocab_size), "cuda", **kw)
    launches = read_launches()
    del params_gpu
    cpu, cpu_s = run_engine(model, params_cpu, parity_requests(cfg.vocab_size), "cpu", **kw)
    divergences = compare_greedy(model, params_cpu, gpu, cpu, "ssm_parity")
    counters = compare_counters(gpu, cpu, "ssm_parity, card against CPU")
    L, d, pd = cfg.n_layers, gpu.dispatches, gpu.prefill_dispatches
    require(launches["ssd"] == L * pd,
            f"ssd launched {launches['ssd']} times for {pd} prefill dispatches")
    require(launches["rmsnorm"] == (L + 1) * d,
            f"rmsnorm launched {launches['rmsnorm']} times for {d} dispatches")
    require(launches["paged_attention"] == 0 and launches["flash_attention"] == 0,
            f"attention kernels launched in an SSM run: {launches}")
    rec = {"phase": "ssm_parity", "arch": cfg.name, "dtype": "float32", "layers": L,
           "cache_mode": "dense", "tokens_equal": not divergences, "divergences": divergences,
           "counters_card_cpu": counters, "launches": launches,
           "ssd_per_prefill_dispatch": launches["ssd"] / pd,
           "rmsnorm_per_dispatch": launches["rmsnorm"] / d, "card_s": gpu_s, "cpu_s": cpu_s}
    emit(rec)
    return rec


def ssd_work(b, nc, q, h, p, n, item) -> tuple:
    """Bytes (x, B, C in their type, dA and dt in f32 read once; Y_diag and
    the states written once in f32) and operations (2 per multiply-add of
    C.B^T and of Y_diag over the causal triangle, and of the states):
    ``(bytes, flops of C.B^T, flops of Y_diag and the states)``."""
    tri = q * (q + 1) // 2
    nbytes = (b * nc * q * (h * p + 2 * n) * item + 2 * b * nc * q * h * 4
              + b * nc * q * h * p * 4 + b * nc * h * p * n * 4)
    return nbytes, 2 * b * nc * tri * n, 2 * b * nc * (h * tri * p + h * q * p * n)


def ssd_bound(nbytes, s_flops, yst_flops, dtype) -> dict:
    """The kernel's bound on the route it takes: bf16, C.B^T one pass and
    Y_diag and the states three passes (M and w x in three bf16 parts) at
    the card's bf16 tensor-core peak; f32, C.B^T in order on the fp32 CUDA
    cores and Y_diag and the states as three TF32 passes on the tensor
    cores.  The all-CUDA-core figure stands beside it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    if dtype == torch.bfloat16:
        t_ops = (s_flops + 3 * yst_flops) / PEAK_OPS[torch.bfloat16]
        route = ("bf16 tensor cores (989 TFLOP/s): C.B^T one pass, Y_diag and states three "
                 "(M and w x in three bf16 parts)")
    else:
        t_ops = max(s_flops / PEAK_OPS[torch.float32], 3 * yst_flops / TF32_OPS)
        route = ("C.B^T on the fp32 CUDA cores (67 TFLOP/s); Y_diag and states 3xTF32: "
                 "3 passes at 494.7 TFLOP/s")
    cc_ms, cc_by = bound(nbytes, s_flops + yst_flops, torch.float32)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bound_route": route,
            "bound_ms_cuda_core": cc_ms, "bound_by_cuda_core": cc_by}


def time_ssd(label, b, nc, q, dtype, lengths=None, n: int = 128) -> dict:
    """The SSD kernel at 64 heads of 64 and state ``n`` (mamba2-1.3b's 128,
    zamba2-1.2b's 64)."""
    from repro_torch.kernels.ssd import ssd_chunk, ssd_chunk_plain

    h, p = 64, 64
    x, dt, A, B, C = ssd_inputs(b, nc, q, h, p, n, dtype, 70, lengths)
    dA = dt * A
    kern = lambda: ssd_chunk(x, dA, dt, B, C)  # noqa: E731
    plain = lambda: ssd_chunk_plain(x, dA, dt, B, C)  # noqa: E731
    got, want = kern(), None
    torch.cuda.synchronize()
    want = plain()
    err = max((got[0] - want[0]).abs().max().item(), (got[1] - want[1]).abs().max().item())
    t = ssd_tol(dtype)
    require(all(bool(torch.allclose(g, w, atol=t, rtol=t)) for g, w in zip(got, want)),
            f"ssd ({label}) disagrees with its plain version at {t} (max err {err})")
    del got, want
    bounds = ssd_bound(*ssd_work(b, nc, q, h, p, n, x.element_size()), dtype)
    return {"at": label, "shape": {"b": b, "nc": nc, "q": q, "h": h, "p": p, "n": n},
            "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain, iters=10), **bounds,
            "library_ms": None,
            "library_call": "none: no one PyTorch call computes the SSD chunk term"}


SSM_SERVE_KW = dict(max_batch=16, max_len=640, prefill_chunk=16, cache_mode="dense")


def phase_ssm_serve(cfg, params) -> dict:
    """Full-width mamba2-1.3b in bf16 on the dense state cache: 32
    requests (prompts 128-512, 64 new tokens), tokens/s, per-dispatch
    times, peak memory; 16 decode dispatches traced; the SSD kernel at the
    serve prefill shape and RMSNorm at d = 2048 timed beside their bounds."""
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.serving.engine import Request, ServeEngine

    dtype = torch.bfloat16
    model = Model(cfg, ModelRuntime(dtype=dtype))
    warm = [Request(uid=f"w{i}", prompt=list(range(1, 40 + i)), max_new_tokens=4)
            for i in range(2)]
    run_engine(model, params, warm, "cuda", **SSM_SERVE_KW)
    reqs = serve_requests(cfg.vocab_size)
    eng = ServeEngine(model, params, device="cuda", **SSM_SERVE_KW)
    eng._decode, eng._prefill = DispatchTimer(eng._decode), DispatchTimer(eng._prefill)
    eng.submit(reqs)
    release_device_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    outs = {r.uid: r.output for r in eng.finished}
    require(len(outs) == len(reqs), "not every SSM serve request finished")
    require(all(len(o) == 64 and all(0 <= t < cfg.vocab_size for t in o) for o in outs.values()),
            "an SSM serve request emitted a wrong number of tokens or an id outside the vocab")
    L, d, pd = cfg.n_layers, eng.dispatches, eng.prefill_dispatches
    require(launches["ssd"] == L * pd, f"ssd launches {launches['ssd']} != {L}/prefill dispatch")
    require(launches["rmsnorm"] == (L + 1) * d, f"rmsnorm launches != {L + 1}/dispatch")
    rec = {
        "phase": "ssm_serve", "arch": cfg.name, "dtype": "bfloat16", "cache_mode": "dense",
        "requests": len(reqs), "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "max_new_tokens": 64, "max_batch": 16, "prefill_chunk": 16, "wall_s": wall,
        "tokens_emitted": eng.tokens_emitted, "tokens_per_s": eng.tokens_emitted / wall,
        "dispatches": d, "prefill_dispatches": pd, "decode_dispatches": eng.decode_dispatches,
        "decode_dispatch_ms": summary(eng._decode.ms()),
        "prefill_dispatch_ms": summary(eng._prefill.ms()),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "peak_cache_bytes": eng.peak_cache_bytes, "launches": launches,
    }
    del eng
    # where a decode dispatch's time goes: 16 rows at prompts 256
    rng = np.random.default_rng(5)
    eng = ServeEngine(model, params, device="cuda", **SSM_SERVE_KW)
    eng.submit([Request(uid=f"q{i}", prompt=rng.integers(1, cfg.vocab_size, 256).tolist(),
                        max_new_tokens=64) for i in range(16)])
    while eng.decode_dispatches < 4:  # prompts drain in 16 prefill dispatches, then decode
        eng.step()
    d0, p0 = eng.decode_dispatches, eng.prefill_dispatches
    ticks = 16
    rec["profile"] = {"what": "decode dispatch, 16 rows, prompts 256", "ticks": ticks,
                      **trace(eng.step, ticks, "dispatch")}
    require(eng.decode_dispatches - d0 == 2 * ticks and eng.prefill_dispatches == p0,
            "traced SSM ticks were not all decode dispatches")
    del eng
    rec["kernel_times"] = {
        "ssd": {"serve_prefill": time_ssd("serve_prefill", 16, 1, 16, dtype,
                                          rng.integers(0, 17, 16).tolist())},
        "rmsnorm": {"decode": time_rmsnorm("decode", 16, cfg.d_model, dtype),
                    "prefill": time_rmsnorm("prefill", 16 * 16, cfg.d_model, dtype)},
    }
    emit(rec)
    return rec


SSM_EVAL_JOB = {"arch": SSM_ARCH, "run": "ssm"}
# Logits with the SSD kernel against the plain chunked scan: f32 differs by
# summation order only; bf16 activations round each layer's small
# differences, compounded over the layers.
SSM_LOGIT_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-1}


def phase_ssm_eval(cfg, params, store_root: Path) -> dict:
    """The eval runner on a checkpoint of the seed-0 weights (bf16, written
    with the port's ``save_state``), bf16 and f32 at 8 x 512 and 2 x 4096:
    finite loss, an SSD launch a layer and an RMSNorm a layer and ``ln_f``
    per forward; logits with the kernel against ``use_ssd_kernel=False``,
    in f32 within ``SSM_LOGIT_TOL``, in bf16 by ``witness_gate`` (the f32
    plain forward of the same checkpoint the witness, the SSD controls); a
    traced forward, and the SSD kernel timed at both shapes.  The logits
    gates are held after the phase has emitted its record."""
    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch.train import run_eval
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.train.checkpoint import restore_state, save_state
    from repro_torch.train.data import DataConfig, SyntheticLM

    torch.backends.cuda.matmul.allow_tf32 = False
    store = ObjectStore(str(store_root / "ssm"))
    t0 = time.perf_counter()
    save_state(store, SSM_EVAL_JOB["run"], 0, params)
    save_s = time.perf_counter() - t0
    n_batches, L = 3, cfg.n_layers
    rec = {"phase": "ssm_eval", "arch": cfg.name, "checkpoint_dtype": "bfloat16",
           "checkpoint_save_s": save_s, "runs": [], "kernel_times": []}
    plain_rt = {"use_ssd_kernel": False}
    misses = []
    for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        job = {**SSM_EVAL_JOB, "dtype": name, "n_batches": n_batches}
        base = Model(cfg, ModelRuntime(dtype=dtype))
        restored, _ = restore_state(store, job["run"], 0, base.abstract_params(), device="cuda")
        for b, s in EVAL_SHAPES:
            events: list = []
            reset_launches()
            out = run_eval({**job, "seq_len": s, "global_batch": b}, store,
                           heartbeat_events(events), device="cuda")
            launches = read_launches()
            ms = event_intervals_ms(events)
            require(launches["ssd"] == L * n_batches and launches["rmsnorm"] == (L + 1) * n_batches,
                    f"ssm_eval {name} {b}x{s}: launches {launches}, want {L} SSD and {L + 1} "
                    "RMSNorm per forward")
            require(math.isfinite(out["loss"]), f"ssm_eval {name} {b}x{s}: loss not finite")
            batch = SyntheticLM(cfg, DataConfig(seq_len=s, global_batch=b, seed=1234),
                                device="cuda").batch(0)

            def logits(dtype=dtype, params=restored, **rt):
                with torch.no_grad():
                    return Model(cfg, ModelRuntime(dtype=dtype, **{"use_ssd_kernel": True, **rt})
                                 ).forward(params, batch["tokens"])

            if dtype == torch.bfloat16:
                p32 = cast_params(restored, torch.float32, "cuda")
                gate = witness_gate(logits, plain_rt, cfg,
                                    lambda **rt: logits(torch.float32, p32, **rt), ssd_controls())
                del p32
                err = gate["issue_gate"]["against_plain_max_abs"]
                if not gate["held"]:
                    misses.append(f"{name} {b}x{s}: {gate['miss']} ({gate})")
            else:
                gate = f32_logits_gate(logits, plain_rt)
                err = gate["against_plain_max_abs"]
                if not gate["held"]:
                    misses.append(f"{name} {b}x{s}: kernel logits differ from the plain scan "
                                  f"by {err} ({gate})")
            evaluator = Model(cfg, ModelRuntime(dtype=dtype))
            with torch.no_grad():
                profile = trace(lambda: float(evaluator.loss(restored, batch)[0]), 1, "forward",
                                watch=("ssd_chunk_kernel",))
            rec["runs"].append({
                "dtype": name, "batch": b, "seq_len": s, "loss": out["loss"], "ppl": out["ppl"],
                "forward_ms": summary(ms), "tokens_per_s": b * s / (summary(ms)["median"] / 1e3),
                "launches": launches,
                "launches_per_forward": {k: v / n_batches for k, v in launches.items()},
                "logits_kernel_vs_plain_max_abs_err": err, "logits_gate": gate,
                "profile": profile})
            rec["kernel_times"].append(time_ssd(f"{name}_{b}x{s}", b, s // 128, 128, dtype))
        del restored, logits
    emit(rec)
    require(not misses, "ssm_eval: " + "; ".join(misses))
    return rec


# ------------------------------------------------------------------ the hybrid family
HYBRID_ARCH = "zamba2-1.2b"
LORA_B_SEED = 1  # the numpy generator of the non-zero lora_b draw


def hybrid_norms(cfg) -> int:
    """RMSNorm launches a dispatch or forward: one a mamba2 layer (d_model),
    ``ln1`` and ``ln2`` a shared-block invocation (2 d_model) and ``ln_f``:
    51 at zamba2-1.2b's 38 layers and 6 invocations."""
    return cfg.n_layers + 2 * (cfg.n_layers // cfg.shared_attn_every) + 1


def require_hybrid_launches(cfg, launches: dict, dispatches: int, prefill_dispatches: int,
                            what: str) -> None:
    """A hybrid serving run's exact launches: an SSD a layer a prefill
    dispatch and none a decode one, ``hybrid_norms`` RMSNorm a dispatch,
    every one on the one-pass path (d 2048 and 4096 are compiled in), no
    attention kernel (the shared block's decode and prefill attend the
    dense cache in plain torch, as the dense family's do)."""
    L, norms = cfg.n_layers, hybrid_norms(cfg)
    require(launches["ssd"] == L * prefill_dispatches,
            f"{what}: ssd launched {launches['ssd']} times for {prefill_dispatches} prefill "
            f"dispatches, want {L} a prefill dispatch and none a decode one")
    require(launches["rmsnorm"] == norms * dispatches,
            f"{what}: rmsnorm launched {launches['rmsnorm']} times for {dispatches} dispatches, "
            f"want {norms} a dispatch")
    require(launches["rmsnorm_one_pass"] == launches["rmsnorm"],
            f"{what}: RMSNorm took the generic path: {launches}")
    require(launches["paged_attention"] == 0 and launches["flash_attention"] == 0,
            f"{what}: attention kernels launched in a dense hybrid serving run: {launches}")


def hybrid_weights():
    """Full-width zamba2-1.2b weights from seed 0, drawn once on the host in
    f32 and reused by every hybrid phase.  ``lora_b`` is redrawn non-zero
    (the reference's zero init leaves the per-invocation LoRA invisible)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.tree import tree_leaves

    cfg = get_arch(HYBRID_ARCH)
    t0 = time.perf_counter()
    params = Model(cfg, ModelRuntime(dtype=torch.float32)).init(0, device="cpu")
    lb = params["shared"]["lora_b"]
    std = 1.0 / math.sqrt(cfg.shared_attn_lora_rank)
    draw = np.random.default_rng(LORA_B_SEED).standard_normal(tuple(lb.shape), dtype=np.float32)
    params["shared"]["lora_b"] = torch.from_numpy(draw * np.float32(std))
    emit({"phase": "hybrid_weights",
          "note": f"lora_b drawn non-zero, normal of std 1/sqrt({cfg.shared_attn_lora_rank}) "
                  f"from numpy default_rng({LORA_B_SEED}), in the one tree the card and the CPU "
                  "both use: the reference's zero init would leave the per-invocation LoRA "
                  "invisible to every gate"})
    emit({"phase": "hybrid_weights", "arch": cfg.name, "seconds": time.perf_counter() - t0,
          "parameters": sum(t.numel() for t in tree_leaves(params)),
          "shared_block_parameters": sum(t.numel() for t in tree_leaves(params["shared"])),
          "lora_b_std": std})
    return cfg, params


HYBRID_KW = dict(max_batch=4, max_len=128, prefill_chunk=16, cache_mode="dense")
# The first 8 of zamba2-1.2b's 38 layers: one full segment of 6 (the shared
# block's first invocation) and 2 trailing layers past it, so _shared_at's
# trailing rule still runs; the depth cut keeps the CPU side short.
# hybrid_serve runs them too (a depth cut of a timing phase),
# hybrid_static and hybrid_eval all 38.
HYBRID_PARITY_LAYERS = 8
HYBRID_SERVE_LAYERS = 8


def phase_hybrid_parity(cfg, params_cpu) -> dict:
    """Full-width zamba2-1.2b in f32, the first ``HYBRID_PARITY_LAYERS`` of
    its layers: the dense-cache engine on the card (SSD kernel at prefill,
    RMSNorm at d 2048 and 4096) against the same engine on the CPU,
    ``parity``'s 6 requests: equal greedy tokens (the near-tie exception of
    ``phase_parity``) and counters, the exact launches of
    ``require_hybrid_launches``."""
    from repro_torch.models import Model, ModelRuntime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params_cpu = first_layers(cfg, params_cpu, HYBRID_PARITY_LAYERS)
    model = Model(cfg, ModelRuntime(dtype=torch.float32))
    params_gpu = cast_params(params_cpu, torch.float32, "cuda")
    reset_launches()
    gpu, gpu_s = run_engine(model, params_gpu, parity_requests(cfg.vocab_size), "cuda",
                            **HYBRID_KW)
    launches = read_launches()
    del params_gpu
    cpu, cpu_s = run_engine(model, params_cpu, parity_requests(cfg.vocab_size), "cpu",
                            **HYBRID_KW)
    divergences = compare_greedy(model, params_cpu, gpu, cpu, "hybrid_parity")
    counters = compare_counters(gpu, cpu, "hybrid_parity, card against CPU")
    d, pd = gpu.dispatches, gpu.prefill_dispatches
    require_hybrid_launches(cfg, launches, d, pd, "hybrid_parity")
    rec = {"phase": "hybrid_parity", "arch": cfg.name, "dtype": "float32",
           "layers": cfg.n_layers, "shared_block_invocations": cfg.n_layers // cfg.shared_attn_every,
           "cache_mode": "dense", "tokens_equal": not divergences, "divergences": divergences,
           "counters_card_cpu": counters, "launches": launches,
           "ssd_per_prefill_dispatch": launches["ssd"] / pd,
           "rmsnorm_per_dispatch": launches["rmsnorm"] / d, "card_s": gpu_s, "cpu_s": cpu_s}
    del cpu, gpu
    release_device_memory()
    emit(rec)
    return rec


def lora_merge_ms(cfg, shared: dict) -> dict:
    """The per-invocation LoRA merge one dispatch makes, ``wq + lora_a[i] @
    lora_b[i]`` for every invocation, timed alone as the model runs it,
    beside its bound: read ``wq`` and both factors, write the merged
    ``wq``."""
    n_inv = cfg.n_layers // cfg.shared_attn_every
    wq, la, lb = shared["attn"]["wq"], shared["lora_a"], shared["lora_b"]

    def merge():
        for inv in range(n_inv):
            wq + (la[inv] @ lb[inv]).to(wq.dtype)

    item = wq.element_size()
    nbytes = n_inv * (2 * wq.numel() + la[0].numel() + lb[0].numel()) * item
    flops = n_inv * 2 * la.shape[1] * la.shape[2] * lb.shape[2]
    bms, by = bound(nbytes, flops, wq.dtype)
    return {"invocations": n_inv, "ms_per_dispatch": time_ms(merge), "bound_ms": bms,
            "bound_by": by, "bytes": nbytes, "flops": flops}


def phase_hybrid_serve(cfg, params) -> dict:
    """Full-width zamba2-1.2b in bf16 on the dense cache at ``ssm_serve``'s
    knobs: 32 requests (prompts 128-512, 64 new tokens), tokens/s,
    per-dispatch times, peak memory, the exact launches; 16 decode
    dispatches traced, the LoRA merge's share of one named; RMSNorm at
    d 4096 and the SSD kernel at state 64 timed beside their bounds."""
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.serving.engine import Request, ServeEngine

    dtype = torch.bfloat16
    model = Model(cfg, ModelRuntime(dtype=dtype))
    warm = [Request(uid=f"w{i}", prompt=list(range(1, 40 + i)), max_new_tokens=4)
            for i in range(2)]
    run_engine(model, params, warm, "cuda", **SSM_SERVE_KW)
    reqs = serve_requests(cfg.vocab_size)
    eng = ServeEngine(model, params, device="cuda", **SSM_SERVE_KW)
    eng._decode, eng._prefill = DispatchTimer(eng._decode), DispatchTimer(eng._prefill)
    eng.submit(reqs)
    release_device_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    outs = {r.uid: r.output for r in eng.finished}
    require(len(outs) == len(reqs), "not every hybrid serve request finished")
    require(all(len(o) == 64 and all(0 <= t < cfg.vocab_size for t in o) for o in outs.values()),
            "a hybrid serve request emitted a wrong number of tokens or an id outside the vocab")
    d, pd = eng.dispatches, eng.prefill_dispatches
    require_hybrid_launches(cfg, launches, d, pd, "hybrid_serve")
    rec = {
        "phase": "hybrid_serve", "arch": cfg.name, "dtype": "bfloat16", "cache_mode": "dense",
        "requests": len(reqs), "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "max_new_tokens": 64, "max_batch": 16, "prefill_chunk": 16, "wall_s": wall,
        "tokens_emitted": eng.tokens_emitted, "tokens_per_s": eng.tokens_emitted / wall,
        "dispatches": d, "prefill_dispatches": pd, "decode_dispatches": eng.decode_dispatches,
        "decode_dispatch_ms": summary(eng._decode.ms()),
        "prefill_dispatch_ms": summary(eng._prefill.ms()),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "peak_cache_bytes": eng.peak_cache_bytes,
        "cache_bytes": {k: v.numel() * v.element_size() if isinstance(v, torch.Tensor)
                        else sum(t.numel() * t.element_size() for t in v.values())
                        for k, v in eng.cache.items()},
        "launches": launches,
    }
    del eng
    # where a decode dispatch's time goes: 16 rows at prompts 256
    rng = np.random.default_rng(5)
    eng = ServeEngine(model, params, device="cuda", **SSM_SERVE_KW)
    eng.submit([Request(uid=f"q{i}", prompt=rng.integers(1, cfg.vocab_size, 256).tolist(),
                        max_new_tokens=64) for i in range(16)])
    while eng.decode_dispatches < 4:  # prompts drain in 16 prefill dispatches, then decode
        eng.step()
    d0, p0 = eng.decode_dispatches, eng.prefill_dispatches
    ticks = 16
    profile = trace(eng.step, ticks, "dispatch",
                    watch=("rmsnorm_row_kernel", "rmsnorm_generic", "ssd_chunk_kernel"))
    require(eng.decode_dispatches - d0 == 2 * ticks and eng.prefill_dispatches == p0,
            "traced hybrid ticks were not all decode dispatches")
    del eng
    merge = lora_merge_ms(cfg, params["shared"])
    merge["share_of_device_busy"] = merge["ms_per_dispatch"] / profile["device_busy_ms_per_dispatch"]
    merge["share_of_wall"] = merge["ms_per_dispatch"] / profile["wall_ms_per_dispatch"]
    rec["profile"] = {"what": "decode dispatch, 16 rows, prompts 256", "ticks": ticks, **profile,
                      "lora_merge": merge}
    rec["kernel_times"] = {
        "ssd": {"serve_prefill_n64": time_ssd("serve_prefill_n64", 16, 1, 16, dtype,
                                              rng.integers(0, 17, 16).tolist(), n=cfg.ssm_state)},
        "rmsnorm": {"decode": time_rmsnorm("decode", 16, 2 * cfg.d_model, dtype),
                    "prefill": time_rmsnorm("prefill", 16 * 16, 2 * cfg.d_model, dtype)},
    }
    emit(rec)
    return rec


HYBRID_EVAL_JOB = {"arch": HYBRID_ARCH, "run": "zamba2_bf16"}


def hybrid_workdir(root: Path) -> Path:
    """The run_ds workdir of the static hybrid job, whose store holds the
    bf16 checkpoint that ``hybrid_static`` serves and ``hybrid_eval``
    evaluates."""
    return root / "hybrid"


def save_hybrid_checkpoint(params, store_root: Path) -> float:
    """The bf16 checkpoint of the hybrid weights that ``hybrid_static``
    serves and ``hybrid_eval`` evaluates; returns the seconds it took."""
    from repro_torch.core.storage import ObjectStore
    from repro_torch.train.checkpoint import save_state

    t0 = time.perf_counter()
    save_state(ObjectStore(str(hybrid_workdir(store_root) / "wd" / "store")),
               HYBRID_EVAL_JOB["run"], 0, params)
    return time.perf_counter() - t0


# In bf16 no two routes through a full-depth model agree within
# SSM_LOGIT_TOL's 1e-1: a difference anywhere changes which way later
# activations round, so any two routes end about as far apart as bf16 is
# from f32 (0.33 at most at logits of std 1 in zamba2).  The reference's own
# direct and chunked attention miss it against each other by 3x
# (tools/reference_bf16_routes.py); mamba2's plain scan with float64
# products misses it against the plain scan by 1.66x (tools/kernel_variants.py
# ssd_logits).  So in bf16 the kernels are held to an f32 run of the same
# weights (the witness): each batch row's mean distance from it at most
# WITNESS_ROW_RATIO times the plain path's.  Correct routes land within 2% of
# the plain path.  The controls put faults into the kernels' outputs; each
# one that the 1e-1 comparison fails in f32, where bf16 noise is absent,
# must land above the ratio, or the gate is blind and the phase fails.
WITNESS_ROW_RATIO = 1.04


def worst_over(x: torch.Tensor, ref: torch.Tensor, t: float) -> float:
    """The worst element's share of ``torch.allclose``'s allowance
    ``t + t |ref|``: above 1 where ``allclose(x, ref, atol=t, rtol=t)``
    fails."""
    return ((x - ref).abs() / (t + t * ref.abs())).max().item()


def row_distance(x: torch.Tensor, witness: torch.Tensor, vocab: int) -> torch.Tensor:
    """Each batch row's mean ``|x - witness|`` over its positions and the
    vocabulary (the padded columns left out)."""
    return (x[..., :vocab] - witness[..., :vocab]).abs().mean(dim=(1, 2))


@contextlib.contextmanager
def patched(module, name: str, wrap):
    """A context in which ``module.name`` is ``wrap(module.name)``."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _scaled(scale: float, pick, row=None):
    """A wrapper whose call multiplies ``pick(out)`` (one tensor of the
    real call's output) by ``scale`` on batch row ``row`` or all rows,
    through ``pick``'s in-place view of a copy."""
    def wrap(real):
        def call(*args, **kw):
            out = real(*args, **kw)
            out = tuple(o.clone() for o in out) if isinstance(out, tuple) else out.clone()
            view = pick(out)
            if row is None:
                view *= scale
            else:
                view[row] *= scale
            return out
        return call
    return wrap


def flash_controls() -> dict:
    """Faults in the flash kernel's output, which still launches:
    name -> (module, attribute, wrapper)."""
    from repro_torch.kernels import ops

    return {"flash output x1.01": (ops, "flash_attention", _scaled(1.01, lambda o: o)),
            "flash output x1.02 on batch row 0": (ops, "flash_attention",
                                                  _scaled(1.02, lambda o: o, row=0))}


def ssd_controls() -> dict:
    """Faults in the SSD kernel's outputs, which still launches: the op's
    output (b, l, h, p) on half the heads, and the chunk states (b, nc, h,
    p, n) on half the heads, so that the fault enters through the
    inter-chunk scan."""
    from repro_torch.kernels import ops

    return {"SSD output x1.08 on half the heads": (
                ops, "ssd", _scaled(1.08, lambda o: o[0][:, :, : o[0].shape[2] // 2])),
            "chunk states x1.08 on half the heads": (
                ops, "ssd_chunk", _scaled(1.08, lambda o: o[1][:, :, : o[1].shape[2] // 2]))}


def f32_logits_gate(logits, plain_rt: dict) -> dict:
    """The f32 logits gate of ``ssm_eval`` and ``hybrid_eval``: the
    kernels' logits (``logits()``) finite and within ``SSM_LOGIT_TOL`` of
    the plain path's (``logits(**plain_rt)``)."""
    plain, kern = logits(**plain_rt), logits()
    t = SSM_LOGIT_TOL[torch.float32]
    return {"tol": t, "against_plain_max_abs": (kern - plain).abs().max().item(),
            "worst_over_gate": worst_over(kern, plain, t),
            "held": bool(torch.isfinite(kern).all())
            and bool(torch.allclose(kern, plain, atol=t, rtol=t))}


def witness_gate(logits, plain_rt: dict, cfg, witness_logits, controls: dict,
                 alone: dict = None, plain_variants: dict = None) -> dict:
    """The bf16 logits gate of ``ssm_eval`` and ``hybrid_eval``.
    ``logits(**rt)`` is the bf16 forward with runtime knobs ``rt`` (none:
    the kernels); ``witness_logits(**rt)`` the same in f32 on the same
    weights.  Holds every batch row's distance ratio (kernels over plain
    path, from the f32 plain path) at most ``WITNESS_ROW_RATIO``, and every
    control (``controls``: name -> (module, attribute, wrapper)) whose f32
    run fails ``SSM_LOGIT_TOL``'s 1e-1 comparison above it; a control that
    passes that comparison is reported and not required.  Reports the 1e-1
    comparison for the kernels against the plain path, and for each of
    ``plain_variants`` (name -> knobs) against the plain path, and each of
    ``alone`` (name -> knobs: one kernel swapped in over the plain path).
    """
    vocab, t = cfg.vocab_size, SSM_LOGIT_TOL[torch.bfloat16]
    witness = witness_logits(**plain_rt)
    plain = logits(**plain_rt)
    base = row_distance(plain, witness, vocab)

    def ratios(x):
        return (row_distance(x, witness, vocab) / base).tolist()

    kern = logits()
    finite = bool(torch.isfinite(kern).all())
    gate = {"row_ratio_limit": WITNESS_ROW_RATIO, "row_ratios": ratios(kern),
            "row_distance_plain": base.tolist(),
            "issue_gate": {
                "tol": t, "against_plain_max_abs": (kern - plain).abs().max().item(),
                "worst_over_gate": worst_over(kern, plain, t),
                **{f"{name}_worst_over_gate": worst_over(logits(**{**plain_rt, **rt}), plain, t)
                   for name, rt in (plain_variants or {}).items()}},
            "from_f32_plain": {route: {"max": (x - witness).abs().max().item(),
                                       "mean": (x - witness).abs().mean().item()}
                               for route, x in (("kernels", kern), ("plain", plain))},
            "controls": {}}
    if alone:
        gate["by_kernel_alone"] = {k: (logits(**{**plain_rt, **rt}) - plain).abs().max().item()
                                   for k, rt in alone.items()}
    del kern
    for what, (module, attr, wrap) in controls.items():
        with patched(module, attr, wrap):
            faulty = logits()
            f32_worst = worst_over(witness_logits(), witness, t)
        gate["controls"][what] = {"row_ratios": ratios(faulty),
                                  "f32_worst_over_issue_gate": f32_worst,
                                  "required": f32_worst > 1}
        del faulty
    worst = max(gate["row_ratios"])
    blind = [w for w, c in gate["controls"].items()
             if c["required"] and max(c["row_ratios"]) <= WITNESS_ROW_RATIO]
    gate["held"] = finite and worst <= WITNESS_ROW_RATIO and not blind
    if not gate["held"]:
        gate["miss"] = ("kernel logits not finite" if not finite else
                        f"a row's distance ratio {worst} above {WITNESS_ROW_RATIO}"
                        if worst > WITNESS_ROW_RATIO else
                        f"controls within the ratio, the gate is blind to them: {blind}")
    return gate


def phase_hybrid_eval(cfg, store_root: Path, save_s: float) -> dict:
    """The eval runner on the bf16 checkpoint of the hybrid weights, bf16
    and f32 at 8 x 512 and 2 x 4096: finite loss, an SSD a layer,
    ``hybrid_norms`` RMSNorm (one pass) and a flash launch (hd 128) an
    invocation a forward; in f32, logits with the kernels against the plain
    path (``use_ssd_kernel=False``, ``attn_impl="direct"``) within
    ``SSM_LOGIT_TOL``, the gate the dense and mamba2 evals hold; in bf16,
    ``witness_gate`` with the flash and SSD controls; a traced forward;
    flash at hd 128 and SSD at
    state 64 timed at each shape.  The logits gates are held after the
    phase has measured and emitted all of this, so a miss leaves its
    numbers behind."""
    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch.train import run_eval
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.train.checkpoint import restore_state
    from repro_torch.train.data import DataConfig, SyntheticLM

    torch.backends.cuda.matmul.allow_tf32 = False
    store = ObjectStore(str(hybrid_workdir(store_root) / "wd" / "store"))
    n_batches, L = 3, cfg.n_layers
    n_inv, norms = L // cfg.shared_attn_every, hybrid_norms(cfg)
    hd = 2 * cfg.d_model // cfg.n_heads
    rec = {"phase": "hybrid_eval", "arch": cfg.name, "checkpoint_dtype": "bfloat16",
           "checkpoint_save_s": save_s, "runs": [],
           "kernel_times": {"flash_attention": [], "ssd": []}}
    plain_rt = dict(use_ssd_kernel=False, attn_impl="direct")
    misses = []
    for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        job = {**HYBRID_EVAL_JOB, "dtype": name, "n_batches": n_batches}
        base = Model(cfg, ModelRuntime(dtype=dtype))
        restored, _ = restore_state(store, job["run"], 0, base.abstract_params(), device="cuda")
        for b, s in EVAL_SHAPES:
            events: list = []
            reset_launches()
            out = run_eval({**job, "seq_len": s, "global_batch": b}, store,
                           heartbeat_events(events), device="cuda")
            launches = read_launches()
            ms = event_intervals_ms(events)
            require(launches["ssd"] == L * n_batches and launches["rmsnorm"] == norms * n_batches
                    and launches["rmsnorm_one_pass"] == launches["rmsnorm"]
                    and launches["flash_attention"] == n_inv * n_batches,
                    f"hybrid_eval {name} {b}x{s}: launches {launches}, want {L} SSD, {norms} "
                    f"one-pass RMSNorm and {n_inv} flash per forward")
            require(math.isfinite(out["loss"]), f"hybrid_eval {name} {b}x{s}: loss not finite")
            batch = SyntheticLM(cfg, DataConfig(seq_len=s, global_batch=b, seed=1234),
                                device="cuda").batch(0)

            def logits(**rt):
                with torch.no_grad():
                    return Model(cfg, ModelRuntime(dtype=dtype, **rt)).forward(
                        restored, batch["tokens"])

            if dtype == torch.bfloat16:
                with torch.no_grad():
                    p32 = cast_params(restored, torch.float32, "cuda")
                    gate = witness_gate(
                        logits, plain_rt, cfg,
                        lambda **rt: Model(cfg, ModelRuntime(dtype=torch.float32, **rt)).forward(
                            p32, batch["tokens"]),
                        {**flash_controls(), **ssd_controls()},
                        alone={"ssd": {"use_ssd_kernel": True}, "flash": {"attn_impl": "kernel"}},
                        plain_variants={"plain_chunked_vs_direct": {"attn_impl": "chunked"}})
                del p32
                err = gate["issue_gate"]["against_plain_max_abs"]
                if not gate["held"]:
                    misses.append(f"{name} {b}x{s}: {gate['miss']} ({gate})")
            else:
                gate = f32_logits_gate(logits, plain_rt)
                err = gate["against_plain_max_abs"]
                if not gate["held"]:
                    misses.append(f"{name} {b}x{s}: kernel logits differ from the plain path "
                                  f"by {err} ({gate})")
            evaluator = Model(cfg, ModelRuntime(dtype=dtype))
            with torch.no_grad():
                profile = trace(lambda: float(evaluator.loss(restored, batch)[0]), 1, "forward",
                                watch=("ssd_chunk_kernel", "flash_", "rmsnorm_row_kernel"))
            rec["runs"].append({
                "dtype": name, "batch": b, "seq_len": s, "loss": out["loss"], "ppl": out["ppl"],
                "forward_ms": summary(ms), "tokens_per_s": b * s / (summary(ms)["median"] / 1e3),
                "launches": launches,
                "launches_per_forward": {k: v / n_batches for k, v in launches.items()},
                "logits_kernels_vs_plain_max_abs_err": err, "logits_gate": gate,
                "profile": profile})
            rec["kernel_times"]["flash_attention"].append(
                time_flash(b * cfg.n_heads, s, dtype, hd=hd))
            rec["kernel_times"]["ssd"].append(
                time_ssd(f"{name}_{b}x{s}_n64", b, s // 128, 128, dtype, n=cfg.ssm_state))
        del restored
    emit(rec)
    require(not misses, "hybrid_eval: " + "; ".join(misses))
    return rec


def phase_hybrid_static(cfg, params, root: Path) -> dict:
    """``parity``'s 6 requests as a static ``distributed-serve`` job of
    zamba2-1.2b in bf16 through the four commands, serving the checkpoint
    of ``save_hybrid_checkpoint``: completions and counters equal to a direct
    engine on the card over the same weights, the exact launches of
    ``require_hybrid_launches``."""
    from repro_torch.launch import serve
    from repro_torch.models import Model, ModelRuntime

    t0 = time.perf_counter()
    reqs = parity_requests(cfg.vocab_size)
    job = {**HYBRID_EVAL_JOB, "dtype": "bfloat16", "max_new_tokens": 24, **HYBRID_KW}
    reset_launches()
    store = ds_commands(hybrid_workdir(root), "DSZamba", {"payload": "distributed-serve"},
                        {**job, "groups": [{"prompts": [r.prompt for r in reqs],
                                            "output_prefix": "serve/zamba2"}]})
    launches = read_launches()
    res = store.get_json("serve/zamba2/RESULTS.json")
    direct, _ = run_engine(Model(cfg, ModelRuntime(dtype=torch.bfloat16)), params,
                           parity_requests(cfg.vocab_size), "cuda", **HYBRID_KW)
    got = {f"p{u.removeprefix('req')}": o for u, o in ds_completions(res).items()}
    require(got == {r.uid: r.output for r in direct.finished},
            "hybrid_static: the job's completions differ from a direct engine on the card")
    counters = {c: [res[c], getattr(direct, c)] for c in PARITY_COUNTERS}
    require(all(a == b for a, b in counters.values()),
            f"hybrid_static: the job's counters differ from a direct engine's: {counters}")
    require_hybrid_launches(cfg, launches, res["dispatches"], res["prefill_dispatches"],
                            "hybrid_static")
    rec = {"phase": "hybrid_static", "arch": cfg.name, "dtype": "bfloat16",
           "tokens_equal_direct_engine": True, "counters": counters, "launches": launches,
           "wall_s": time.perf_counter() - t0}
    del direct
    serve._MODEL_CACHE.clear()
    serve._PARAM_CACHE.clear()
    release_device_memory()
    emit(rec)
    return rec


# ------------------------------------------------------------------ the dense zoo
ZOO_ARCHS = ("granite-34b", "qwen2-72b", "nemotron-4-340b")
ZOO_SEED = 0  # of the card's generator: zoo weights are drawn on the card (Model.draw)
ZOO_BIAS_STD = 0.5  # qwen2's bq/bk/bv drawn non-zero: q, k and v are ~N(0, 1) at init
# Depth cuts, never widths.  zoo_parity in f32: granite-34b and qwen2-72b at
# 1 layer (card and CPU copies), nemotron-4-340b at 1 (51.6 GB, on the card
# only).  zoo_serve in bf16: granite-34b at 3 of its 88 layers (11, then 6
# before cuts for the time limit), qwen2-72b at 4 (8 before a cut),
# nemotron-4-340b at 2 (30.4 GiB).
ZOO_PARITY_LAYERS = {"granite-34b": 1, "qwen2-72b": 1, "nemotron-4-340b": 1}
ZOO_SERVE_LAYERS = {"granite-34b": 3, "qwen2-72b": 4, "nemotron-4-340b": 2}
# The paged kernel's path of a decode dispatch (T 1) and of a prefill one
# (T 16) by model and dtype: G = n_heads / n_kv_heads queries fold onto a KV head
ZOO_PATHS = {  # f32 on the tensor cores in 3xTF32
    ("granite-34b", torch.float32): ("tensor_core", "tensor_core"),  # G*T 48 and 768
    ("granite-34b", torch.bfloat16): ("tensor_core", "tensor_core"),  # key splits; 6 row groups
    ("qwen2-72b", torch.float32): ("decode", "tensor_core"),  # G*T 8 at dk 128; 128 rows
    ("qwen2-72b", torch.bfloat16): ("decode", "tensor_core"),  # 128 rows: 8 M-tiles
    ("nemotron-4-340b", torch.float32): ("tensor_core", "tensor_core"),  # dk 192: 12, 192 rows
    ("nemotron-4-340b", torch.bfloat16): ("tensor_core", "tensor_core"),
}
ZOO_PARITY_KW = dict(max_batch=4, max_len=128, prefill_chunk=16)
# parity's 6 requests at 4 new tokens each, not 24 (8 before the training
# phases past ds-paper-100m came in): the CPU side's decode dispatches
# (qwen2-72b's 152k-entry head on the host) are most of the phase's time
# (a cut for the time limit; p5 still hits p0's published prefix, and
# later decodes read K/V that earlier decodes wrote)
ZOO_PARITY_NEW = 4
ZOO_SERVE_KW = dict(max_batch=16, max_len=640, prefill_chunk=16, page_size=16,
                    cache_mode="paged")
ZOO_TRACE_TICKS = 8
ZOO_DISPATCH_COUNTERS = ("dispatches", "prefill_dispatches", "decode_dispatches",
                         "tokens_emitted")


def zoo_requests(vocab: int):
    return parity_requests(vocab, ZOO_PARITY_NEW)


def zoo_model(arch: str, layers: int, dtype):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime

    return Model(dataclasses.replace(get_arch(arch), n_layers=layers), ModelRuntime(dtype=dtype))


def zoo_weights(model) -> tuple:
    """The model's weights drawn on the card from ``ZOO_SEED`` by
    ``Model.draw`` (straight into its dtype, no host copy), a QKV bias
    redrawn non-zero there (the reference's zeros would leave it invisible
    to every gate): ``(params, record)``."""
    from repro_torch.tree import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(ZOO_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.draw(gen)
    if model.cfg.qkv_bias:
        for layer in params["layers"]:
            for name in ("bq", "bk", "bv"):
                layer["attn"][name].normal_(0.0, ZOO_BIAS_STD, generator=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    leaves = tree_leaves(params)
    require(all(t.is_cuda for t in leaves), f"{model.cfg.name}: a weight was drawn off the card")
    return params, {"draw_s": seconds, "layers": model.cfg.n_layers,
                    "parameters": sum(t.numel() for t in leaves),
                    "parameter_bytes": sum(t.numel() * t.element_size() for t in leaves),
                    "qkv_bias_std": ZOO_BIAS_STD if model.cfg.qkv_bias else None}


def run_recorded(model, params, reqs, device, **kw):
    """``run_engine`` keeping every dispatch's logits on its live rows (a
    prefill dispatch's rows with tokens, a decode dispatch's rows the
    scheduler made active) beside the inputs that produced them:
    ``(engine, seconds, dispatches)``."""
    from repro_torch.serving.engine import ServeEngine

    eng = ServeEngine(model, params, device=device, **kw)
    calls, active = [], []
    build = eng._build_decode_inputs

    def build_inputs():
        out = build()
        active.append(list(out[0]))
        return out

    def recorded(fn, kind):
        def call(params, cache, tokens, *args):
            logits, cache = fn(params, cache, tokens, *args)
            rows, lg = ((active[-1], logits[:, 0]) if kind == "decode"
                        else (args[-1].nonzero()[:, 0].tolist(), logits))  # args: offsets, lengths
            calls.append({"kind": kind, "inputs": [t.cpu() for t in (tokens, *args)],
                          "rows": rows,
                          "logits": lg[rows, :model.cfg.vocab_size].float().cpu()})
            return logits, cache
        return call

    eng._build_decode_inputs = build_inputs
    model.decode_step = recorded(model.decode_step, "decode")
    model.prefill_chunk = recorded(model.prefill_chunk, "prefill")
    try:
        eng.submit(reqs)
        t0 = time.perf_counter()
        eng.run_to_completion()
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        del model.decode_step, model.prefill_chunk  # the class's methods again
    return eng, seconds, calls


def compare_dispatch_logits(a: list, b: list, divergent: bool, what: str) -> dict:
    """Hold two runs' dispatches against each other, logits at parity's
    tolerance (rtol ``PARITY_RTOL``, atol ``PARITY_PARAM_ATOL``), for as
    long as both ran the same inputs on the same rows: every dispatch
    unless ``divergent`` (a near-tie ``compare_greedy`` admitted sends the
    runs down different tokens from there)."""
    held, err, ratio = 0, 0.0, 0.0
    for x, y in zip(a, b):
        if (x["kind"] != y["kind"] or x["rows"] != y["rows"]
                or not all(torch.equal(u, v) for u, v in zip(x["inputs"], y["inputs"]))):
            break
        diff = (x["logits"] - y["logits"]).abs()
        if diff.numel():
            err = max(err, float(diff.max()))
            ratio = max(ratio, float((diff / (PARITY_PARAM_ATOL
                                              + PARITY_RTOL * y["logits"].abs())).max()))
        held += 1
    require(divergent or held == len(a) == len(b),
            f"{what}: the runs' dispatches differ at {held} of {len(a)} / {len(b)} with equal "
            "tokens")
    require(ratio <= 1.0, f"{what}: logits {ratio}x past rtol {PARITY_RTOL} / atol "
            f"{PARITY_PARAM_ATOL} (max abs {err})")
    return {"dispatches_held": held, "dispatches": [len(a), len(b)], "max_abs_err": err,
            "worst_over_tolerance": ratio}


def require_zoo_launches(cfg, dtype, launches: dict, eng, paged: bool, what: str) -> None:
    """A zoo serving run's exact launches: on the paged engine a paged
    launch a layer a dispatch, a decode dispatch's on the decode path of
    ``ZOO_PATHS`` and a prefill dispatch's on its prefill path (none on
    the dense engine); 2 L + 1 RMSNorm a dispatch, every one on the one-pass
    path (6144, 8192 and 18432 are compiled into it); no flash or SSD
    launch."""
    from repro_torch.kernels.flash_decode import PATHS

    L, d = cfg.n_layers, eng.dispatches
    decode, prefill = ZOO_PATHS[(cfg.name, dtype)]
    want = dict.fromkeys(PATHS, 0)
    if paged:
        want[decode] += L * eng.decode_dispatches
        want[prefill] += L * eng.prefill_dispatches
    got = {p: launches[f"paged_attention_{p}"] for p in PATHS}
    require(got == want and launches["paged_attention"] == sum(want.values()),
            f"{what}: paged launches by path {got}, want {want} ({L} layers, "
            f"{eng.decode_dispatches} decode and {eng.prefill_dispatches} prefill dispatches)")
    require(launches["rmsnorm"] == (2 * L + 1) * d == launches["rmsnorm_one_pass"],
            f"{what}: rmsnorm launched {launches['rmsnorm']} times "
            f"({launches['rmsnorm_one_pass']} one-pass) for {d} dispatches, want {2 * L + 1} a "
            "dispatch, all one-pass")
    require(launches["flash_attention"] == 0 and launches["ssd"] == 0,
            f"{what}: flash or SSD launched in a serving run: {launches}")


def zoo_parity_cpu(arch: str) -> dict:
    """granite-34b or qwen2-72b: each engine on the card against the same
    engine on the CPU over a CPU copy of the card's tree."""
    from repro_torch.tree import tree_map

    model = zoo_model(arch, ZOO_PARITY_LAYERS[arch], torch.float32)
    cfg = model.cfg
    params, weights = zoo_weights(model)
    params_cpu = tree_map(lambda t: t.cpu(), params)
    rec = {"phase": "zoo_parity", "arch": arch, "dtype": "float32", "weights": weights,
           "against": "the same engine on the CPU", "modes": {}}
    modes = {"paged": dict(ZOO_PARITY_KW, page_size=16, cache_mode="paged"),
             "dense": dict(ZOO_PARITY_KW, cache_mode="dense")}
    for mode, kw in modes.items():
        reset_launches()
        gpu, gpu_s, gpu_calls = run_recorded(model, params, zoo_requests(cfg.vocab_size),
                                             "cuda", **kw)
        launches = read_launches()
        cpu, cpu_s, cpu_calls = run_recorded(model, params_cpu, zoo_requests(cfg.vocab_size),
                                             "cpu", **kw)
        what = f"zoo_parity {arch} {mode}, card against CPU"
        divs = compare_greedy(model, params_cpu, gpu, cpu, what)
        counters = compare_counters(gpu, cpu, what)
        logits = compare_dispatch_logits(gpu_calls, cpu_calls, bool(divs), what)
        require_zoo_launches(cfg, torch.float32, launches, gpu, mode == "paged", what)
        if mode == "paged":
            require(gpu.prefix_hit_tokens > 0, f"{what}: the shared prefix was never hit")
        rec["modes"][mode] = {
            "tokens_equal": not divs, "divergences": divs, "counters_card_cpu": counters,
            "logits": logits, "launches": launches,
            "launches_per_dispatch": {k: v / gpu.dispatches for k, v in launches.items()},
            "card_s": gpu_s, "cpu_s": cpu_s}
    return rec


def zoo_parity_card(arch: str) -> dict:
    """nemotron-4-340b, whose f32 tree is out of the CPU's reach: the card's
    paged engine (the paged kernel) against its dense engine (plain
    ``gqa_attention`` over the per-slot cache), the paged one without its
    prefix cache so that both run the same dispatches."""
    model = zoo_model(arch, ZOO_PARITY_LAYERS[arch], torch.float32)
    cfg = model.cfg
    params, weights = zoo_weights(model)
    rec = {"phase": "zoo_parity", "arch": arch, "dtype": "float32", "weights": weights,
           "against": "the dense engine on the card", "modes": {}}
    modes = {"paged": dict(ZOO_PARITY_KW, page_size=16, cache_mode="paged", prefix_cache=False),
             "dense": dict(ZOO_PARITY_KW, cache_mode="dense")}
    runs = {}
    for mode, kw in modes.items():
        reset_launches()
        eng, seconds, calls = run_recorded(model, params, zoo_requests(cfg.vocab_size),
                                           "cuda", **kw)
        launches = read_launches()
        require_zoo_launches(cfg, torch.float32, launches, eng, mode == "paged",
                             f"zoo_parity {arch} {mode}")
        runs[mode] = (eng, calls)
        rec["modes"][mode] = {
            "launches": launches,
            "launches_per_dispatch": {k: v / eng.dispatches for k, v in launches.items()},
            "card_s": seconds}
    what = f"zoo_parity {arch}, paged against dense on the card"
    (paged, paged_calls), (dense, dense_calls) = runs["paged"], runs["dense"]
    divs = compare_greedy(model, params, paged, dense, what, device="cuda")
    rec["paged_against_dense"] = {
        "tokens_equal": not divs, "divergences": divs,
        "counters": compare_counters(paged, dense, what, ZOO_DISPATCH_COUNTERS),
        "logits": compare_dispatch_logits(paged_calls, dense_calls, bool(divs), what)}
    return rec


def phase_zoo_parity() -> dict:
    """The dense zoo in f32 with TF32 off, weights drawn on the card,
    ``parity``'s 6 requests at ``ZOO_PARITY_NEW`` new tokens
    (``zoo_requests``) through the paged and the dense engine:
    granite-34b (1 layer) and qwen2-72b (1) card against CPU, nemotron-4-340b
    (1) paged against dense on the card (``zoo_parity_cpu``,
    ``zoo_parity_card``): equal greedy tokens (the near-tie exception of
    ``phase_parity``), counters, every dispatch's logits at parity's
    tolerance, and every run's launches exact by path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recs = {}
    for arch in ZOO_ARCHS:
        release_device_memory()
        t0 = time.perf_counter()
        rec = (zoo_parity_card if arch == "nemotron-4-340b" else zoo_parity_cpu)(arch)
        release_device_memory()
        rec["seconds"] = time.perf_counter() - t0
        emit(rec)
        recs[arch] = rec
    return recs


def zoo_serve_arch(arch: str) -> dict:
    from repro_torch.serving.engine import Request, ServeEngine

    dtype = torch.bfloat16
    t_phase = time.perf_counter()
    model = zoo_model(arch, ZOO_SERVE_LAYERS[arch], dtype)
    cfg = model.cfg
    params, weights = zoo_weights(model)
    warm = [Request(uid=f"w{i}", prompt=list(range(1, 40 + i)), max_new_tokens=4)
            for i in range(2)]
    run_engine(model, params, warm, "cuda", **ZOO_SERVE_KW)
    reqs = serve_requests(cfg.vocab_size)
    eng = ServeEngine(model, params, device="cuda", **ZOO_SERVE_KW)
    eng._decode, eng._prefill = DispatchTimer(eng._decode), DispatchTimer(eng._prefill)
    eng.submit(reqs)
    release_device_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    outs = {r.uid: r.output for r in eng.finished}
    require(len(outs) == len(reqs), f"zoo_serve {arch}: not every request finished")
    require(all(len(o) == 64 and all(0 <= t < cfg.vocab_size for t in o) for o in outs.values()),
            f"zoo_serve {arch}: a request emitted a wrong number of tokens or an id outside "
            "the vocab")
    require_zoo_launches(cfg, dtype, launches, eng, True, f"zoo_serve {arch}")
    d = eng.dispatches
    rec = {
        "phase": "zoo_serve", "arch": arch, "dtype": "bfloat16", "weights": weights,
        "requests": len(reqs), "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "max_new_tokens": 64, "max_batch": 16, "page_size": 16, "prefill_chunk": 16,
        "wall_s": wall, "tokens_emitted": eng.tokens_emitted,
        "tokens_per_s": eng.tokens_emitted / wall, "dispatches": d,
        "prefill_dispatches": eng.prefill_dispatches, "decode_dispatches": eng.decode_dispatches,
        "decode_dispatch_ms": summary(eng._decode.ms()),
        "prefill_dispatch_ms": summary(eng._prefill.ms()),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "peak_pages": eng.peak_pages, "total_pages": eng.n_pages,
        "peak_cache_bytes": eng.peak_cache_bytes, "launches": launches,
        "launches_per_dispatch": {k: v / d for k, v in launches.items()},
    }
    del eng
    # where a decode dispatch's time goes: 16 rows at prompts 256
    rng = np.random.default_rng(5)
    eng = ServeEngine(model, params, device="cuda", **ZOO_SERVE_KW)
    eng.submit([Request(uid=f"q{i}", prompt=rng.integers(1, cfg.vocab_size, 256).tolist(),
                        max_new_tokens=64) for i in range(16)])
    while eng.decode_dispatches < 4:  # prompts drain in 16 prefill dispatches, then decode
        eng.step()
    d0, p0 = eng.decode_dispatches, eng.prefill_dispatches
    rec["profile"] = {
        "what": "decode dispatch, 16 rows, prompts 256", "ticks": ZOO_TRACE_TICKS,
        **trace(eng.step, ZOO_TRACE_TICKS, "dispatch",
                watch=("paged_attention_kernel", "paged_tc_kernel", "paged_decode_kernel",
                       "rmsnorm_row_kernel", "rmsnorm_generic_kernel", "gemm", "gemv",
                       "nvjet"))}
    require(eng.decode_dispatches - d0 == 2 * ZOO_TRACE_TICKS and eng.prefill_dispatches == p0,
            f"zoo_serve {arch}: traced ticks were not all decode dispatches")
    del eng, params
    release_device_memory()
    g, hd, hkv = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_kv_heads
    rng = np.random.default_rng(3)
    paged = {
        "decode": time_paged("decode", 16, 1, rng.integers(128, 576, 16).tolist(), dtype,
                             hkv=hkv, g=g, dk=hd),
        "prefill": time_paged("prefill", 16, 16, (16 * rng.integers(0, 32, 16)).tolist(),
                              dtype, hkv=hkv, g=g, dk=hd)}
    require((paged["decode"]["path"], paged["prefill"]["path"]) == ZOO_PATHS[(arch, dtype)],
            f"zoo_serve {arch}: the timed shapes took {paged['decode']['path']} / "
            f"{paged['prefill']['path']}")
    rec["kernel_times"] = {
        "paged_attention": paged,
        "rmsnorm": {"decode": time_rmsnorm("decode", 16, cfg.d_model, dtype),
                    "prefill": time_rmsnorm("prefill", 16 * 16, cfg.d_model, dtype)}}
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def phase_zoo_serve() -> dict:
    """The dense zoo in bf16 through the paged engine at ``serve``'s knobs
    and requests (32, prompts 128-512, 64 new tokens, ``max_batch`` 16,
    page 16), each model freed before the next: granite-34b at 3
    layers, qwen2-72b at 4, nemotron-4-340b at 2 (``ZOO_SERVE_LAYERS``); tokens/s, dispatch times,
    peak memory, launches exact by path, a traced decode dispatch, and
    the paged kernel and RMSNorm at the model's decode and prefill shapes
    beside their bounds, plain versions and library calls."""
    recs = {}
    for arch in ZOO_ARCHS:
        release_device_memory()
        recs[arch] = zoo_serve_arch(arch)
    release_device_memory()
    return recs


# ------------------------------------------------------------------ the MoE family
MOE_ARCH = "mixtral-8x7b"
MOE_WINDOW = 4096  # mixtral-8x7b's sliding window
DANUBE_WINDOW = 4096  # h2o-danube-3-4b's
# Depth cuts, never widths: mixtral-8x7b whole is 46.7 B parameters (93.4 GB
# in bf16).  moe_parity and moe_window in f32 at 1 layer (1.72 B, 6.9 GB on
# the card and again on the host for parity), moe_eval at 2 (3.17 B, 12.7 GB
# in f32), moe_serve in bf16 at 2 (6.3 GB; 4 before a cut for the time
# limit).  Weights are drawn on the card (``zoo_weights``: Model.draw from
# ZOO_SEED).
MOE_PARITY_LAYERS = 1
MOE_EVAL_LAYERS = 2
MOE_SERVE_LAYERS = 2  # 4 before a cut for the time limit
MOE_PARITY_KW = dict(max_batch=16, max_len=128, prefill_chunk=16, cache_mode="dense")
# prompts 16-48, then 8-24, before cuts for the time limit (the CPU side's
# decode dispatches, each reading the layer's 5.6 GB of f32 experts)
MOE_PARITY_PROMPTS = (8, 16)
MOE_SERVE_KW = dict(max_batch=16, max_len=640, prefill_chunk=16, cache_mode="dense")
MOE_WINDOW_POSITIONS = 4608  # past the rolling cache's 4,224 slots and the window
MOE_EVAL_TOKENS = 8192
MOE_COUNTERS = ("dispatches", "prefill_dispatches", "decode_dispatches", "steps_executed",
                "tokens_emitted", "prompt_tokens_ingested", "preemptions", "tokens_discarded",
                "peak_cache_bytes")
MOE_TRACE_TICKS = 8
# device ops of a MoE decode dispatch by what they do (substrings of their
# names); the softmax count includes attention's, so routing is an upper bound
MOE_GEMM_OPS = ("gemm", "gemv", "nvjet")
MOE_ROUTING_OPS = ("softmax", "sort", "Sort", "scatter")


def moe_model(layers: int, dtype, strategy: str = "dense"):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime

    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=layers)
    return Model(cfg, ModelRuntime(dtype=dtype, moe_strategy=strategy))


def moe_parity_requests(vocab: int):
    """16 greedy requests, prompts of ``MOE_PARITY_PROMPTS`` tokens, 8 new
    each."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(4)
    lo, hi = MOE_PARITY_PROMPTS
    return [Request(uid=f"m{i}", prompt=rng.integers(1, vocab, int(n)).tolist(),
                    max_new_tokens=8)
            for i, n in enumerate(rng.integers(lo, hi + 1, 16))]


def require_exact_launches(cfg, launches: dict, dispatches: int, what: str, flash: int = 0,
                           paged: int = 0) -> None:
    """A mixtral, danube, internvl or whisper run's exact launches: 2 L + 1
    RMSNorm a dispatch or forward, every one on the one-pass path (4096,
    3840 and 896 are compiled into it), none where the norm is LayerNorm
    (whisper's, plain torch as in the reference); ``flash`` flash launches;
    ``paged`` paged launches, every one on the decode path (internvl's
    7-row fold, whisper's cross cache; a windowed cache is never paged);
    no SSD (a MoE's expert products are plain GEMMs, as in the
    reference)."""
    want = (2 * cfg.n_layers + 1) * dispatches if cfg.norm == "rmsnorm" else 0
    require(launches["rmsnorm"] == want == launches["rmsnorm_one_pass"],
            f"{what}: rmsnorm launched {launches['rmsnorm']} times "
            f"({launches['rmsnorm_one_pass']} one-pass), want {want}, all one-pass")
    got = {p: launches[f"paged_attention_{p}"] for p in ("cuda_core", "tensor_core", "decode")}
    want_paths = dict(dict.fromkeys(got, 0), decode=paged)
    require(got == want_paths and launches["paged_attention"] == paged,
            f"{what}: paged launches by path {got}, want {paged} on the decode path")
    require(launches["flash_attention"] == flash and launches["ssd"] == 0,
            f"{what}: launches {launches}, want {flash} flash and no SSD")


@contextlib.contextmanager
def counting_drops(cfg):
    """A context in which the MoE router also counts, call by call, the
    entries the capacity paths drop (kept on the card until read)."""
    from repro_torch.models import moe

    counts: list = []

    def wrap(real):
        def route(p, x, top_k):
            gates, ids = real(p, x, top_k)
            per_expert = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)
            counts.append((per_expert - moe.capacity(ids.shape[0], cfg)).clamp(min=0).sum())
            return gates, ids
        return route

    with patched(moe, "route", wrap):
        yield counts


def phase_moe_parity() -> tuple:
    """mixtral-8x7b at 1 layer in f32 (TF32 off), weights drawn on the
    card: the dense-cache engine on the card against the same engine on a
    CPU copy of the tree, 16 requests at ``max_batch`` 16, prompts ingested
    one token a decode dispatch, under ``capacity`` (5 slots an expert at
    16 rows, so entries drop; the count is required above 0) and
    ``dense``: equal greedy tokens (the near-tie exception), every engine
    counter, every dispatch's logits at parity's 1e-4, RMSNorm launches
    exact.  Returns the card's tree for ``moe_window``."""
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = moe_model(MOE_PARITY_LAYERS, torch.float32)
    cfg = base.cfg
    params, weights = zoo_weights(base)
    params_cpu = tree_map(lambda t: t.cpu(), params)
    rec = {"phase": "moe_parity", "arch": cfg.name, "dtype": "float32", "weights": weights,
           "against": "the same engine on the CPU", "requests": 16,
           "knobs": MOE_PARITY_KW, "strategies": {}}
    for strategy in ("capacity", "dense"):
        model = Model(cfg, ModelRuntime(dtype=torch.float32, moe_strategy=strategy))
        reset_launches()
        counting = counting_drops(cfg) if strategy == "capacity" else contextlib.nullcontext([])
        with counting as drops:
            gpu, gpu_s, gpu_calls = run_recorded(model, params, moe_parity_requests(cfg.vocab_size),
                                                 "cuda", **MOE_PARITY_KW)
            dropped = int(sum(int(c) for c in drops))
        launches = read_launches()
        cpu, cpu_s, cpu_calls = run_recorded(model, params_cpu,
                                             moe_parity_requests(cfg.vocab_size), "cpu",
                                             **MOE_PARITY_KW)
        what = f"moe_parity {strategy}, card against CPU"
        divs = compare_greedy(model, params_cpu, gpu, cpu, what)
        counters = compare_counters(gpu, cpu, what, MOE_COUNTERS)
        logits = compare_dispatch_logits(gpu_calls, cpu_calls, bool(divs), what)
        require_exact_launches(cfg, launches, gpu.dispatches, what)
        require(gpu.prefill_dispatches == 0, f"{what}: a MoE prompt took the fused prefill")
        if strategy == "capacity":
            require(dropped > 0, f"{what}: no entry was dropped; the capacity drops went untested")
        rec["strategies"][strategy] = {
            "tokens_equal": not divs, "divergences": divs, "counters_card_cpu": counters,
            "logits": logits, "entries_dropped_on_card": dropped if strategy == "capacity" else 0,
            "launches": launches,
            "launches_per_dispatch": {k: v / gpu.dispatches for k, v in launches.items()},
            "card_s": gpu_s, "cpu_s": cpu_s}
    del params_cpu
    emit(rec)
    return rec, params


def phase_moe_window(params) -> dict:
    """The rolling sliding-window cache on the card: mixtral-8x7b at 1 layer
    in f32 (``dense``: the capacity paths' drops depend on the batch and
    would differ from a full forward), 2 rows decoded one position at a
    time through 4,608 positions of a 4,224-slot cache, so it wraps and the
    4096 window bites.  Each position's logits are held against one full
    forward of the same tokens on the plain chunked path with the window at
    parity's 1e-4, and through the flash kernel at 1e-3; a forward without
    the window must miss the decode logits past position 4096 by more than
    1e-4 (the fault control: else the gate could not see the window)."""
    import dataclasses

    from repro_torch.models import Model, ModelRuntime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = moe_model(MOE_PARITY_LAYERS, torch.float32)
    cfg, n, vocab = model.cfg, MOE_WINDOW_POSITIONS, model.cfg.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(1, vocab, (2, n), generator=gen, device="cuda")
    cache = model.init_cache(2, n, device="cuda")
    slots = cache["k"].shape[2]
    require(cfg.sliding_window < slots < n,
            f"moe_window: {slots} slots do not roll under {n} positions with window "
            f"{cfg.sliding_window}")
    decode = torch.empty((n, 2, vocab), device="cuda")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for pos in range(n):
            lg, cache = model.decode_step(params, cache, tokens[:, pos:pos + 1],
                                          torch.full((2,), pos, device="cuda"))
            decode[pos] = lg[:, 0, :vocab]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = read_launches()
    require_exact_launches(cfg, launches, n, "moe_window decode")
    decode = decode.transpose(0, 1)  # (2, n, vocab)
    del cache

    def forward(window: int, impl: str) -> torch.Tensor:
        m = Model(dataclasses.replace(cfg, sliding_window=window),
                  ModelRuntime(dtype=torch.float32, attn_impl=impl, moe_strategy="dense"))
        with torch.no_grad():
            return m.forward(params, tokens)[..., :vocab]

    w, tol_plain, tol_kernel = cfg.sliding_window, PARITY_RTOL, EVAL_LOGIT_TOL[torch.float32]
    plain = forward(w, "chunked")
    gate_plain = worst_over(decode, plain, tol_plain)
    plain_err = (decode - plain).abs().max().item()
    del plain
    reset_launches()
    kern = forward(w, "kernel")
    kernel_launches = read_launches()
    gate_kernel = worst_over(decode, kern, tol_kernel)
    kernel_err = (decode - kern).abs().max().item()
    del kern
    unwindowed = forward(0, "chunked")
    control = {"tol": tol_plain,
               "worst_over_tol_before_window": worst_over(decode[:, :w], unwindowed[:, :w],
                                                          tol_plain),
               "worst_over_tol_past_window": worst_over(decode[:, w:], unwindowed[:, w:],
                                                        tol_plain)}
    del unwindowed
    rec = {"phase": "moe_window", "arch": cfg.name, "dtype": "float32", "layers": cfg.n_layers,
           "rows": 2, "positions": n, "cache_slots": slots, "window": w,
           "decode_s": decode_s, "decode_ms_per_position": decode_s * 1e3 / n,
           "decode_launches": launches,
           "decode_vs_chunked_forward": {"tol": tol_plain, "max_abs_err": plain_err,
                                         "worst_over_tol": gate_plain},
           "decode_vs_flash_forward": {"tol": tol_kernel, "max_abs_err": kernel_err,
                                       "worst_over_tol": gate_kernel,
                                       "launches": kernel_launches},
           "control_forward_without_window": control}
    emit(rec)
    require(gate_plain <= 1.0, f"moe_window: decode logits {gate_plain}x past {tol_plain} of the "
            "windowed chunked forward")
    require(gate_kernel <= 1.0, f"moe_window: decode logits {gate_kernel}x past {tol_kernel} of "
            "the windowed flash forward")
    require_exact_launches(cfg, kernel_launches, 1, "moe_window flash forward", flash=cfg.n_layers)
    require(control["worst_over_tol_past_window"] > 1.0,
            "moe_window: a forward without the window matches the decode past position "
            f"{w}; the gate cannot see the window")
    return rec


def phase_moe_serve() -> dict:
    """mixtral-8x7b at ``MOE_SERVE_LAYERS`` layers in bf16 on the dense
    (rolling-capable) cache, ``dense`` as the entry points default:
    ``serve``'s 32 requests (prompts 128-512, 64 new, ``max_batch`` 16),
    every prompt ingested one token a decode dispatch (MoE takes no fused
    prefill, as in the reference): tokens/s, dispatch times, peak memory,
    2 L + 1 one-pass RMSNorm a dispatch; one ``capacity`` run's tokens/s beside it (reported: its
    drops make other tokens); 8 decode dispatches traced (GEMM and routing
    device time)."""
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.serving.engine import Request, ServeEngine

    dtype = torch.bfloat16
    t_phase = time.perf_counter()
    model = moe_model(MOE_SERVE_LAYERS, dtype)
    cfg = model.cfg
    params, weights = zoo_weights(model)
    warm = [Request(uid=f"w{i}", prompt=list(range(1, 20 + i)), max_new_tokens=4)
            for i in range(2)]
    run_engine(model, params, warm, "cuda", **MOE_SERVE_KW)
    reqs = serve_requests(cfg.vocab_size)
    eng = ServeEngine(model, params, device="cuda", **MOE_SERVE_KW)
    eng._decode = DispatchTimer(eng._decode)
    eng.submit(reqs)
    release_device_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms = []  # host clock: each step syncs on its sampled tokens
    t0 = time.perf_counter()
    while eng.pending or eng.scheduler.has_active():
        t_step = time.perf_counter()
        eng.step()
        step_ms.append((time.perf_counter() - t_step) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    outs = {r.uid: r.output for r in eng.finished}
    require(len(outs) == len(reqs), "moe_serve: not every request finished")
    require(all(len(o) == 64 and all(0 <= t < cfg.vocab_size for t in o) for o in outs.values()),
            "moe_serve: a request emitted a wrong number of tokens or an id outside the vocab")
    require(eng.prefill_dispatches == 0, "moe_serve: a MoE prompt took the fused prefill")
    require_exact_launches(cfg, launches, eng.dispatches, "moe_serve")
    d = eng.dispatches
    rec = {
        "phase": "moe_serve", "arch": cfg.name, "dtype": "bfloat16", "weights": weights,
        "moe_strategy": "dense", "cache_mode": "dense", "cache_slots": eng.cache["k"].shape[2],
        "requests": len(reqs), "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "max_new_tokens": 64, "max_batch": 16, "wall_s": wall,
        "tokens_emitted": eng.tokens_emitted, "tokens_per_s": eng.tokens_emitted / wall,
        "dispatches": d, "decode_dispatches": eng.decode_dispatches,
        "dispatch_wall_ms": summary(step_ms),
        "decode_dispatch_device_span_ms": summary(eng._decode.ms()),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "peak_cache_bytes": eng.peak_cache_bytes, "launches": launches,
        "launches_per_dispatch": {k: v / d for k, v in launches.items()},
    }
    del eng
    capacity = Model(cfg, ModelRuntime(dtype=dtype, moe_strategy="capacity"))
    reset_launches()
    cap_eng, cap_wall = run_engine(capacity, params, serve_requests(cfg.vocab_size), "cuda",
                                   **MOE_SERVE_KW)
    cap_launches = read_launches()
    require_exact_launches(cfg, cap_launches, cap_eng.dispatches, "moe_serve capacity")
    cap_outs = {r.uid: r.output for r in cap_eng.finished}
    require(len(cap_outs) == len(reqs), "moe_serve capacity: not every request finished")
    rec["capacity"] = {
        "wall_s": cap_wall, "tokens_per_s": cap_eng.tokens_emitted / cap_wall,
        "dispatches": cap_eng.dispatches, "launches": cap_launches,
        "tokens_equal_to_dense": sum(a == b for u in outs
                                     for a, b in zip(outs[u], cap_outs[u])),
        "tokens_compared": sum(len(o) for o in outs.values())}
    del cap_eng
    # where a decode dispatch's time goes: 16 rows deep in their prompts
    rng = np.random.default_rng(5)
    eng = ServeEngine(model, params, device="cuda", **MOE_SERVE_KW)
    eng.submit([Request(uid=f"q{i}", prompt=rng.integers(1, cfg.vocab_size, 256).tolist(),
                        max_new_tokens=64) for i in range(16)])
    for _ in range(4):
        eng.step()
    d0 = eng.decode_dispatches
    profile = trace(eng.step, MOE_TRACE_TICKS, "dispatch",
                    watch=MOE_GEMM_OPS + MOE_ROUTING_OPS + ("rmsnorm_row_kernel",))
    require(eng.decode_dispatches - d0 == 2 * MOE_TRACE_TICKS,
            "moe_serve: traced ticks were not all decode dispatches")
    watched = profile["watched_ops"]
    profile["gemm_ms_per_dispatch"] = sum(watched[w]["ms_per_dispatch"] for w in MOE_GEMM_OPS)
    profile["routing_ms_per_dispatch"] = sum(watched[w]["ms_per_dispatch"]
                                             for w in MOE_ROUTING_OPS)
    # each dispatch's busy time alone, one traced tick at a time
    profile["device_busy_ms"] = summary([
        trace(eng.step, 1, "dispatch")["device_busy_ms_per_dispatch"]
        for _ in range(MOE_TRACE_TICKS)])
    rec["profile"] = {"what": "decode dispatch, 16 rows, prompts 256", "ticks": MOE_TRACE_TICKS,
                      **profile}
    del eng, params
    release_device_memory()
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def plain_rmsnorm(real):
    """``ops.rmsnorm`` replaced by the kernel's plain version (the eval's
    plain path: no kernel launched)."""
    from repro_torch.kernels.rmsnorm import rmsnorm_plain

    def norm(x, w, *, eps=1e-5):
        return rmsnorm_plain(x.reshape(-1, x.shape[-1]), w, eps).reshape(x.shape)
    return norm


def phase_moe_eval() -> dict:
    """mixtral-8x7b at 2 layers over 1 x 8192 tokens of the eval runner's
    synthetic stream, ``dense``, weights drawn on the card.  f32 (TF32
    off): the kernels (flash at hd 128 with the 4096 window, RMSNorm)
    against the plain path (chunked attention, plain RMSNorm) at the eval
    gate 1e-3, with exact launches (2 flash, 5 one-pass RMSNorm a forward)
    and a finite loss.  bf16 on the same weights: timed and reported (its
    distance from the f32 plain path), finite, launches exact.  Then flash
    at BH 32 x 8192, hd 128, window 4096 timed in both dtypes beside its
    bound (the windowed pair count), its plain version and SDPA with the
    same window as a boolean mask."""
    from repro_torch.train.data import DataConfig, SyntheticLM

    t_phase = time.perf_counter()
    model = moe_model(MOE_EVAL_LAYERS, torch.float32)
    cfg = model.cfg
    params, weights = zoo_weights(model)
    batch = SyntheticLM(cfg, DataConfig(seq_len=MOE_EVAL_TOKENS, global_batch=1, seed=1234),
                        device="cuda").batch(0)
    rec = {"phase": "moe_eval", "arch": cfg.name, "weights": weights, "batch": 1,
           "seq_len": MOE_EVAL_TOKENS, "moe_strategy": "dense", "kernel_times": []}
    rec["runs"], misses = eval_runs("moe_eval", cfg, params, batch, moe_strategy="dense")
    del params
    release_device_memory()
    for dtype in (torch.bfloat16, torch.float32):  # BH: 1 row of n_heads
        rec["kernel_times"].append(time_flash(cfg.n_heads, MOE_EVAL_TOKENS, dtype,
                                              hd=cfg.resolved_head_dim, window=MOE_WINDOW))
        release_device_memory()
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    require(not misses, "moe_eval: " + "; ".join(misses))
    return rec


# ------------------------------------------------------------------ MLA (deepseek)
MLA_ARCH = "deepseek-v2-236b"
# Depth cuts, never widths: deepseek-v2-236b whole is 235.7 B parameters
# (472 GB in bf16).  mla_parity in f32 at 2 layers, the dense first layer
# and one MoE layer (5.36 B, 21.4 GB on the card and again on the host),
# mla_serve in bf16 at 2 (10.7 GB; 4 before a cut for the time limit).
# Weights are drawn on the card (``zoo_weights``: Model.draw from ZOO_SEED).
MLA_PARITY_LAYERS = 2
MLA_SERVE_LAYERS = 2
MLA_PARITY_KW = dict(max_batch=16, max_len=32, prefill_chunk=16, page_size=16,
                     cache_mode="paged")
# prompts 8-24, then 4-12, before cuts for the time limit (the CPU side's
# decode dispatches over 160 f32 experts)
MLA_PARITY_PROMPTS = (4, 8)
MLA_SERVE_KW = dict(max_batch=16, max_len=640, prefill_chunk=16, page_size=16,
                    cache_mode="paged")
MLA_FORWARD_SHAPE = (2, 128)
MLA_COUNTERS = MOE_COUNTERS + ("prefix_hit_tokens", "peak_pages", "page_allocs", "pages_in_use",
                               "n_pages", "page_bytes")
MLA_TRACE_TICKS = 8


def mla_model(layers: int, dtype, strategy: str = "dense"):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime

    cfg = dataclasses.replace(get_arch(MLA_ARCH), n_layers=layers)
    return Model(cfg, ModelRuntime(dtype=dtype, moe_strategy=strategy))


def mla_parity_requests(vocab: int):
    """16 greedy requests, prompts of ``MLA_PARITY_PROMPTS`` tokens, 4 new
    each."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(8)
    lo, hi = MLA_PARITY_PROMPTS
    return [Request(uid=f"d{i}", prompt=rng.integers(1, vocab, int(n)).tolist(),
                    max_new_tokens=4)
            for i, n in enumerate(rng.integers(lo, hi + 1, 16))]


def require_mla_launches(cfg, launches: dict, dispatches: int, what: str, dtype,
                         paged: bool = True) -> None:
    """An MLA run's exact launches a dispatch or forward: one paged launch a
    layer on the paged cache (the latent fold, dk 576 / dv 512: on the
    tensor-core path in bf16 and f32), none on the
    dense cache or in a forward; 4 L + 1 RMSNorm (``ln1``, ``q_norm``,
    ``kv_norm``, ``ln2`` a layer, ``ln_f``), every one on the one-pass path
    (5120, 1536 and 512 are compiled in); no flash (MLA is plain einsums,
    as in the reference) or SSD."""
    L = cfg.n_layers
    want_paged = L * dispatches if paged else 0
    path = "tensor_core"
    got = {p: launches[f"paged_attention_{p}"] for p in ("cuda_core", "tensor_core", "decode")}
    want_paths = dict.fromkeys(got, 0)
    want_paths[path] = want_paged
    require(got == want_paths and launches["paged_attention"] == want_paged,
            f"{what}: paged launches by path {got}, want {want_paged} on the {path} path "
            f"({L} layers, {dispatches} dispatches)")
    want = (4 * L + 1) * dispatches
    require(launches["rmsnorm"] == want == launches["rmsnorm_one_pass"],
            f"{what}: rmsnorm launched {launches['rmsnorm']} times "
            f"({launches['rmsnorm_one_pass']} one pass), want {want}, all one pass")
    require(launches["flash_attention"] == 0 and launches["ssd"] == 0,
            f"{what}: flash or SSD launched: {launches}")


def phase_mla_parity() -> dict:
    """deepseek-v2-236b at 2 layers (the dense first layer and one MoE
    layer) in f32 with TF32 off, weights drawn on the card.  The paged
    engine (the latent pool through the paged kernel) on the card against
    the same engine on a CPU copy of the tree, 16 requests at ``max_batch``
    16 (the fold B 16 x G 128), prompts ingested one token a decode
    dispatch, under ``capacity`` (entries must drop) and ``dense``: equal
    greedy tokens (the near-tie exception), every engine counter, every
    dispatch's logits at parity's 1e-4, launches exact.  Then the dense
    ``c_kv``/``k_rope`` engine on the card against the paged one on the
    card (tokens, logits at 1e-4), and one ``Model.forward`` of 2 x 128
    tokens under ``capacity`` (the eval path) card against CPU at 1e-4."""
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    base = mla_model(MLA_PARITY_LAYERS, torch.float32)
    cfg = base.cfg
    params, weights = zoo_weights(base)
    params_cpu = tree_map(lambda t: t.cpu(), params)
    rec = {"phase": "mla_parity", "arch": cfg.name, "dtype": "float32", "weights": weights,
           "against": "the same engine on the CPU", "requests": 16, "knobs": MLA_PARITY_KW,
           "strategies": {}}
    card = {}
    for strategy in ("capacity", "dense"):
        model = Model(cfg, ModelRuntime(dtype=torch.float32, moe_strategy=strategy))
        reset_launches()
        counting = counting_drops(cfg) if strategy == "capacity" else contextlib.nullcontext([])
        with counting as drops:
            gpu, gpu_s, gpu_calls = run_recorded(model, params, mla_parity_requests(cfg.vocab_size),
                                                 "cuda", **MLA_PARITY_KW)
            dropped = int(sum(int(c) for c in drops))
        launches = read_launches()
        cpu, cpu_s, cpu_calls = run_recorded(model, params_cpu,
                                             mla_parity_requests(cfg.vocab_size), "cpu",
                                             **MLA_PARITY_KW)
        what = f"mla_parity {strategy}, card against CPU"
        divs = compare_greedy(model, params_cpu, gpu, cpu, what)
        counters = compare_counters(gpu, cpu, what, MLA_COUNTERS)
        logits = compare_dispatch_logits(gpu_calls, cpu_calls, bool(divs), what)
        require_mla_launches(cfg, launches, gpu.dispatches, what, torch.float32)
        require(gpu.prefill_dispatches == 0, f"{what}: a MoE prompt took the fused prefill")
        if strategy == "capacity":
            require(dropped > 0, f"{what}: no entry was dropped; the capacity drops went untested")
        card[strategy] = (gpu, gpu_calls)
        rec["strategies"][strategy] = {
            "tokens_equal": not divs, "divergences": divs, "counters_card_cpu": counters,
            "logits": logits, "entries_dropped_on_card": dropped if strategy == "capacity" else 0,
            "launches": launches,
            "launches_per_dispatch": {k: v / gpu.dispatches for k, v in launches.items()},
            "card_s": gpu_s, "cpu_s": cpu_s}
    # the dense latent cache against the paged one, both on the card
    model = Model(cfg, ModelRuntime(dtype=torch.float32, moe_strategy="dense"))
    dense_kw = {k: v for k, v in MLA_PARITY_KW.items() if k != "page_size"}
    reset_launches()
    dense, dense_s, dense_calls = run_recorded(model, params, mla_parity_requests(cfg.vocab_size),
                                               "cuda", **dict(dense_kw, cache_mode="dense"))
    launches = read_launches()
    what = "mla_parity dense cache against paged, on the card"
    require_mla_launches(cfg, launches, dense.dispatches, what, torch.float32, paged=False)
    paged, paged_calls = card["dense"]
    divs = compare_greedy(model, params_cpu, dense, paged, what)
    rec["dense_cache_against_paged"] = {
        "tokens_equal": not divs, "divergences": divs,
        "counters": compare_counters(dense, paged, what, ZOO_DISPATCH_COUNTERS),
        "logits": compare_dispatch_logits(dense_calls, paged_calls, bool(divs), what),
        "launches": launches, "card_s": dense_s,
        "cache_bytes": {"dense": dense.peak_cache_bytes, "paged": paged.peak_cache_bytes}}
    del dense, paged, card
    # one forward (the eval path) under capacity, card against CPU
    model = Model(cfg, ModelRuntime(dtype=torch.float32, moe_strategy="capacity"))
    gen = torch.Generator().manual_seed(9)
    tokens = torch.randint(1, cfg.vocab_size, MLA_FORWARD_SHAPE, generator=gen)
    reset_launches()
    with torch.no_grad():
        got = model.forward(params, tokens.cuda())[..., :cfg.vocab_size].cpu()
    launches = read_launches()
    require_mla_launches(cfg, launches, 1, "mla_parity forward", torch.float32, paged=False)
    with torch.no_grad():
        want = model.forward(params_cpu, tokens)[..., :cfg.vocab_size]
    gate = worst_over(got, want, PARITY_RTOL)
    rec["forward"] = {"shape": list(MLA_FORWARD_SHAPE), "moe_strategy": "capacity",
                      "tol": PARITY_RTOL, "max_abs_err": (got - want).abs().max().item(),
                      "worst_over_tol": gate, "finite": bool(torch.isfinite(got).all()),
                      "launches": launches}
    del params, params_cpu
    release_device_memory()
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    require(rec["forward"]["finite"] and gate <= 1.0,
            f"mla_parity: forward logits {gate}x past {PARITY_RTOL} card against CPU")
    return rec


def phase_mla_serve() -> dict:
    """deepseek-v2-236b at ``MLA_SERVE_LAYERS`` layers in bf16 through the
    paged engine, ``dense`` as the entry points' default: ``serve``'s 32 requests (prompts
    128-512, 64 new, ``max_batch`` 16, page 16), every prompt ingested one
    token a decode dispatch (a MoE takes no fused prefill, as in the
    reference): tokens/s, dispatch wall median and p99, peak memory, the
    latent cache's peak bytes beside what a per-head cache (128 heads x
    (192 K + 128 V)) would hold for the same pages, launches exact; 8
    decode dispatches traced (busy, idle share, GEMM, paged, RMSNorm and
    routing device time); the paged kernel at the MLA fold and RMSNorm at
    5120, 1536 and 512 timed beside their bounds, plain versions and
    library calls."""
    from repro_torch.serving.engine import Request, ServeEngine

    dtype = torch.bfloat16
    t_phase = time.perf_counter()
    model = mla_model(MLA_SERVE_LAYERS, dtype)
    cfg = model.cfg
    params, weights = zoo_weights(model)
    warm = [Request(uid=f"w{i}", prompt=list(range(1, 20 + i)), max_new_tokens=4)
            for i in range(2)]
    run_engine(model, params, warm, "cuda", **MLA_SERVE_KW)
    reqs = serve_requests(cfg.vocab_size)
    eng = ServeEngine(model, params, device="cuda", **MLA_SERVE_KW)
    eng._decode = DispatchTimer(eng._decode)
    eng.submit(reqs)
    release_device_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms = []  # host clock: each step syncs on its sampled tokens
    t0 = time.perf_counter()
    while eng.pending or eng.scheduler.has_active():
        t_step = time.perf_counter()
        eng.step()
        step_ms.append((time.perf_counter() - t_step) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    outs = {r.uid: r.output for r in eng.finished}
    require(len(outs) == len(reqs), "mla_serve: not every request finished")
    require(all(len(o) == 64 and all(0 <= t < cfg.vocab_size for t in o) for o in outs.values()),
            "mla_serve: a request emitted a wrong number of tokens or an id outside the vocab")
    require(eng.prefill_dispatches == 0, "mla_serve: a MoE prompt took the fused prefill")
    require_mla_launches(cfg, launches, eng.dispatches, "mla_serve", dtype)
    d, ps, item = eng.dispatches, MLA_SERVE_KW["page_size"], 2
    per_head = (eng.peak_pages * ps * cfg.n_layers * cfg.n_heads
                * (cfg.nope_head_dim + cfg.rope_head_dim + cfg.v_head_dim) * item)
    rec = {
        "phase": "mla_serve", "arch": cfg.name, "dtype": "bfloat16", "weights": weights,
        "moe_strategy": "dense", "cache_mode": "paged", "requests": len(reqs),
        "prompt_tokens": sum(len(r.prompt) for r in reqs), "max_new_tokens": 64,
        "max_batch": 16, "page_size": ps, "wall_s": wall, "tokens_emitted": eng.tokens_emitted,
        "tokens_per_s": eng.tokens_emitted / wall, "dispatches": d,
        "decode_dispatches": eng.decode_dispatches, "dispatch_wall_ms": summary(step_ms),
        "decode_dispatch_device_span_ms": summary(eng._decode.ms()),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "peak_pages": eng.peak_pages, "total_pages": eng.n_pages, "page_bytes": eng.page_bytes,
        "peak_cache_bytes": eng.peak_cache_bytes,
        "per_head_cache_bytes_same_pages": per_head,
        "per_head_over_latent": per_head / eng.peak_cache_bytes,
        "launches": launches, "launches_per_dispatch": {k: v / d for k, v in launches.items()},
    }
    del eng
    # where a decode dispatch's time goes: 16 rows deep in their prompts
    rng = np.random.default_rng(5)
    eng = ServeEngine(model, params, device="cuda", **MLA_SERVE_KW)
    eng.submit([Request(uid=f"q{i}", prompt=rng.integers(1, cfg.vocab_size, 256).tolist(),
                        max_new_tokens=64) for i in range(16)])
    for _ in range(4):
        eng.step()
    d0 = eng.decode_dispatches
    # the keys each row attends in the traced dispatches: its prompt is
    # ingested one token a dispatch, so the rows stand early in it
    positions = [[s.pos for s in eng.scheduler.slots if s.req is not None]]
    profile = trace(eng.step, MLA_TRACE_TICKS, "dispatch",
                    watch=MOE_GEMM_OPS + MOE_ROUTING_OPS + ("paged_mla_kernel",
                                                            "rmsnorm_row_kernel"))
    positions.append([s.pos for s in eng.scheduler.slots if s.req is not None])
    profile["keys_per_row"] = {"before": [min(positions[0]) + 1, max(positions[0]) + 1],
                               "after": [min(positions[1]), max(positions[1])]}
    require(eng.decode_dispatches - d0 == 2 * MLA_TRACE_TICKS,
            "mla_serve: traced ticks were not all decode dispatches")
    watched = profile["watched_ops"]
    profile["gemm_ms_per_dispatch"] = sum(watched[w]["ms_per_dispatch"] for w in MOE_GEMM_OPS)
    profile["routing_ms_per_dispatch"] = sum(watched[w]["ms_per_dispatch"]
                                             for w in MOE_ROUTING_OPS)
    profile["paged_ms_per_dispatch"] = watched["paged_mla_kernel"]["ms_per_dispatch"]
    profile["rmsnorm_ms_per_dispatch"] = watched["rmsnorm_row_kernel"]["ms_per_dispatch"]
    rec["profile"] = {"what": "decode dispatch, 16 rows, prompts 256", "ticks": MLA_TRACE_TICKS,
                      **profile}
    del eng, params
    release_device_memory()
    rng = np.random.default_rng(3)
    offsets = rng.integers(128, 576, 16).tolist()
    rec["kernel_times"] = {
        "paged_attention": {
            **{f"{at}_{tag}": time_paged_mla(f"{at}_{tag}", T, offsets, dt)
               for dt, tag in ((dtype, "bf16"), (torch.float32, "f32"))
               for at, T in (("decode", 1), ("t4", 4))}},
        "rmsnorm": {f"d{dd}_{at}": time_rmsnorm(at, rows, dd, dtype)
                    for dd in (cfg.d_model, cfg.q_lora_rank, cfg.kv_lora_rank)
                    for at, rows in (("decode", 16), ("prefill", 256))}}
    for name, t in rec["kernel_times"]["paged_attention"].items():
        require(t["path"] == "tensor_core", f"mla_serve: the MLA fold {name} took {t['path']}")
    for t in rec["kernel_times"]["rmsnorm"].values():
        require(t["path"] == "one_pass", f"mla_serve: rmsnorm at {t['shape']} took {t['path']}")
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


# ------------------------------------------------------------------ danube and internvl
DANUBE_ARCH = "h2o-danube-3-4b"
VLM_ARCH = "internvl2-1b"
# Depth cuts, never widths.  danube_parity in f32 at 1 of its 24 layers
# (0.64 B parameters, 2.6 GB on the card and again on the host),
# vlm_parity at 2 of 24 (0.21 B); the serve and eval phases at 12 (below)
# (h2o-danube-3-4b 3.97 B, 7.9 GB in bf16; internvl2-1b 0.63 B, 1.3 GB).
# Weights are drawn on the card (``zoo_weights``: Model.draw from ZOO_SEED;
# internvl's QKV bias redrawn non-zero).
DANUBE_PARITY_LAYERS = 1
VLM_PARITY_LAYERS = 2
SLICE_PARITY_KW = dict(max_batch=4, max_len=64, prefill_chunk=16)
# 4608 positions a row make the rolling cache's min(4608, pad128(4097)) =
# 4224 slots: 3.1 GB in bf16 at 16 rows over 24 layers
DANUBE_SERVE_KW = dict(max_batch=16, max_len=4608, prefill_chunk=16, cache_mode="dense")
VLM_SERVE_KW = dict(max_batch=16, max_len=256, prefill_chunk=16, page_size=16,
                    cache_mode="paged")
DANUBE_EVAL_TOKENS = 8192
# danube's serve and eval phases and internvl's run 12 of their 24 layers
# (a depth cut for the time limit; whole before)
SLICE_LAYERS = {DANUBE_ARCH: 12, VLM_ARCH: 12}
VLM_EVAL_SHAPE = (8, 768)  # rows x text tokens: the 256 patches ahead make S 1024
SLICE_TRACE_TICKS = 8


def slice_parity_requests(vocab: int):
    """4 greedy requests, prompts of 24-48 tokens, 16 new each."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(9)
    return [Request(uid=f"v{i}", prompt=rng.integers(1, vocab, int(n)).tolist(),
                    max_new_tokens=16)
            for i, n in enumerate(rng.integers(24, 49, 4))]


def slice_parity(arch: str, layers: int, kw: dict) -> dict:
    """f32 (TF32 off), weights drawn on the card: the engine on the card
    against the same engine on a CPU copy of the tree over
    ``slice_parity_requests``: equal greedy tokens (the near-tie
    exception), every engine counter, every dispatch's logits at parity's
    1e-4, launches exact."""
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    model = zoo_model(arch, layers, torch.float32)
    cfg = model.cfg
    params, weights = zoo_weights(model)
    params_cpu = tree_map(lambda t: t.cpu(), params)
    reset_launches()
    gpu, gpu_s, gpu_calls = run_recorded(model, params, slice_parity_requests(cfg.vocab_size),
                                         "cuda", **kw)
    launches = read_launches()
    cpu, cpu_s, cpu_calls = run_recorded(model, params_cpu,
                                         slice_parity_requests(cfg.vocab_size), "cpu", **kw)
    what = f"{arch} parity, card against CPU"
    divs = compare_greedy(model, params_cpu, gpu, cpu, what)
    on_pages = kw["cache_mode"] == "paged"
    counters = compare_counters(gpu, cpu, what, MLA_COUNTERS if on_pages else MOE_COUNTERS)
    logits = compare_dispatch_logits(gpu_calls, cpu_calls, bool(divs), what)
    paged = cfg.n_layers * gpu.dispatches if on_pages else 0
    require_exact_launches(cfg, launches, gpu.dispatches, what, paged=paged)
    rec = {"arch": arch, "dtype": "float32", "weights": weights,
           "against": "the same engine on the CPU", "requests": 4, "knobs": kw,
           "tokens_equal": not divs, "divergences": divs, "counters_card_cpu": counters,
           "logits": logits, "launches": launches,
           "launches_per_dispatch": {k: v / gpu.dispatches for k, v in launches.items()},
           "card_s": gpu_s, "cpu_s": cpu_s}
    del params, params_cpu
    release_device_memory()
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def phase_danube_parity() -> dict:
    """h2o-danube-3-4b at 1 layer (d_model 3840, 32 query heads of 120 over
    8) in f32 on the dense cache: 64 positions a row, under the 4096
    window, so prompts take the fused prefill (``slice_parity``); 2 L + 1
    RMSNorm at 3840 a dispatch, all one pass."""
    rec = {"phase": "danube_parity",
           **slice_parity(DANUBE_ARCH, DANUBE_PARITY_LAYERS,
                          dict(SLICE_PARITY_KW, cache_mode="dense"))}
    emit(rec)
    return rec


def phase_vlm_parity() -> dict:
    """internvl2-1b at 2 layers (d_model 896, 14 query heads over 2, QKV
    bias) in f32 on the paged engine (``slice_parity``), every prompt
    ingested one token a decode dispatch (a VLM takes no fused prefill, as
    in the reference): a paged launch a layer a dispatch, all on the
    decode path (the 7-row fold), and 2 L + 1 RMSNorm at 896, all one
    pass."""
    rec = {"phase": "vlm_parity",
           **slice_parity(VLM_ARCH, VLM_PARITY_LAYERS,
                          dict(SLICE_PARITY_KW, cache_mode="paged", page_size=16))}
    require(rec["counters_card_cpu"]["prefill_dispatches"] == [0, 0],
            "vlm_parity: a VLM prompt took the fused prefill")
    emit(rec)
    return rec


def slice_serve(arch: str, kw: dict, n_requests: int, prompt: int, new: int) -> tuple:
    """bf16 at ``SLICE_LAYERS``' depth (whole where unnamed), weights drawn
    on the card: ``n_requests`` of
    ``prompt`` tokens and ``new`` new at ``max_batch`` 16, every step timed
    on the host clock (it syncs on its sampled tokens), then 8 decode
    dispatches of 16 rows deep in their prompts traced.  Returns the
    record, the model and the card's tree."""
    from repro_torch.configs import get_arch
    from repro_torch.serving.engine import Request, ServeEngine

    dtype = torch.bfloat16
    model = zoo_model(arch, SLICE_LAYERS.get(arch, get_arch(arch).n_layers), dtype)
    cfg = model.cfg
    params, weights = zoo_weights(model)
    warm = [Request(uid=f"w{i}", prompt=list(range(1, 20 + i)), max_new_tokens=4)
            for i in range(2)]
    run_engine(model, params, warm, "cuda", **kw)
    rng = np.random.default_rng(10)
    reqs = [Request(uid=f"s{i}", prompt=rng.integers(1, cfg.vocab_size, prompt).tolist(),
                    max_new_tokens=new) for i in range(n_requests)]
    eng = ServeEngine(model, params, device="cuda", **kw)
    eng._decode = DispatchTimer(eng._decode)
    eng.submit(reqs)
    release_device_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms = []
    t0 = time.perf_counter()
    while eng.pending or eng.scheduler.has_active():
        t_step = time.perf_counter()
        eng.step()
        step_ms.append((time.perf_counter() - t_step) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    outs = {r.uid: r.output for r in eng.finished}
    name = f"{arch} serve"
    require(len(outs) == len(reqs), f"{name}: not every request finished")
    require(all(len(o) == new and all(0 <= t < cfg.vocab_size for t in o) for o in outs.values()),
            f"{name}: a request emitted a wrong number of tokens or an id outside the vocab")
    require(eng.prefill_dispatches == 0, f"{name}: a prompt took the fused prefill")
    paged = cfg.n_layers * eng.dispatches if kw["cache_mode"] == "paged" else 0
    require_exact_launches(cfg, launches, eng.dispatches, name, paged=paged)
    d = eng.dispatches
    rec = {
        "arch": arch, "dtype": "bfloat16", "weights": weights, "knobs": kw,
        "requests": len(reqs), "prompt_tokens": prompt, "max_new_tokens": new,
        "wall_s": wall, "tokens_emitted": eng.tokens_emitted,
        "tokens_per_s": eng.tokens_emitted / wall, "dispatches": d,
        "decode_dispatches": eng.decode_dispatches, "dispatch_wall_ms": summary(step_ms),
        "decode_dispatch_device_span_ms": summary(eng._decode.ms()),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "peak_cache_bytes": eng.peak_cache_bytes, "launches": launches,
        "launches_per_dispatch": {k: v / d for k, v in launches.items()},
    }
    if kw["cache_mode"] == "dense":
        rec["cache_slots"] = eng.cache["k"].shape[2]
        require(eng.cache_mgr.cache_is_rolling(), f"{name}: the cache does not roll")
    del eng
    eng = ServeEngine(model, params, device="cuda", **kw)
    eng.submit([Request(uid=f"q{i}", prompt=rng.integers(1, cfg.vocab_size, 256).tolist(),
                        max_new_tokens=64) for i in range(16)])
    for _ in range(4):
        eng.step()
    d0 = eng.decode_dispatches
    profile = trace(eng.step, SLICE_TRACE_TICKS, "dispatch",
                    watch=("rmsnorm_row_kernel", "paged_decode_kernel", "gemm", "gemv", "nvjet"))
    require(eng.decode_dispatches - d0 == 2 * SLICE_TRACE_TICKS,
            f"{name}: traced ticks were not all decode dispatches")
    profile["rmsnorm_ms_per_dispatch"] = profile["watched_ops"]["rmsnorm_row_kernel"][
        "ms_per_dispatch"]
    rec["profile"] = {"what": "decode dispatch, 16 rows, prompts 256",
                      "ticks": SLICE_TRACE_TICKS, **profile}
    del eng
    return rec, model, params


def phase_danube_serve() -> dict:
    """h2o-danube-3-4b at 12 of its 24 layers in bf16 on the rolling dense
    cache (4224 slots under its 4096 window): 16 requests of 128 tokens, 64 new,
    every prompt ingested one token a decode dispatch (a rolling cache
    takes no fused prefill, as in the reference): tokens/s, dispatch wall
    median and p99, peak memory, 25 one-pass RMSNorm a dispatch and no
    other launch, a traced decode dispatch (busy, idle share, ops,
    RMSNorm's device time); RMSNorm at 3840 timed."""
    t_phase = time.perf_counter()
    rec, model, params = slice_serve(DANUBE_ARCH, DANUBE_SERVE_KW, 16, 128, 64)
    del params
    release_device_memory()
    rec["kernel_times"] = {"rmsnorm": {
        "decode": time_rmsnorm("decode", 16, model.cfg.d_model, torch.bfloat16)}}
    rec = {"phase": "danube_serve", **rec, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


def phase_vlm_serve() -> dict:
    """internvl2-1b at 12 of its 24 layers in bf16 on the paged engine: 16
    requests of 128 tokens, 32 new, every prompt ingested one token a
    decode dispatch: the numbers of ``danube_serve``, a paged launch a
    layer a dispatch on the decode path (the 7-row fold) and 25 one-pass
    RMSNorm at 896; the paged kernel at the decode fold (B 16, Hkv 2, G 7,
    dk 64, 128-158 keys) in both dtypes and RMSNorm at 896 timed beside
    their bounds, plain versions and SDPA / ``F.rms_norm``."""
    t_phase = time.perf_counter()
    rec, model, params = slice_serve(VLM_ARCH, VLM_SERVE_KW, 16, 128, 32)
    del params
    release_device_memory()
    cfg = model.cfg
    g, hd, hkv = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_kv_heads
    offsets = list(range(128, 160, 2))
    rec["kernel_times"] = {
        "paged_attention": {f"decode_{tag}": time_paged(f"decode_{tag}", 16, 1, offsets, dt,
                                                        P=16, hkv=hkv, g=g, dk=hd)
                            for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))},
        "rmsnorm": {at: time_rmsnorm(at, rows, cfg.d_model, torch.bfloat16)
                    for at, rows in (("decode", 16), ("prefill", 256))}}
    for name, t in rec["kernel_times"]["paged_attention"].items():
        require(t["path"] == "decode", f"vlm_serve: the G 7 fold {name} took {t['path']}")
    for t in rec["kernel_times"]["rmsnorm"].values():
        require(t["path"] == "one_pass", f"vlm_serve: rmsnorm at {t['shape']} took {t['path']}")
    rec = {"phase": "vlm_serve", **rec, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


def flash_per_forward(cfg) -> int:
    """Flash launches a forward makes on the card: one a layer; an
    encoder-decoder's encoder layers and its decoder's cross attention one
    each more."""
    if cfg.is_encoder_decoder:
        return cfg.n_encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def eval_runs(phase: str, cfg, params, batch: dict, **rt) -> tuple:
    """The eval gate of a forward over ``batch`` (tokens, labels, a VLM's
    patches, an encoder-decoder's frames) on ``params`` (f32), ``rt`` the
    runtime's other knobs.  f32 (TF32 off): the kernels (flash, RMSNorm)
    against the plain path (chunked attention, plain RMSNorm; cross
    attention direct, as the reference attends) at the eval gate 1e-3,
    with exact launches (``flash_per_forward`` flash and 2 L + 1 one-pass
    RMSNorm a forward, none under LayerNorm) and a finite loss.  bf16 on
    the same weights: timed and reported (its distance from the f32 plain
    path), finite, launches exact.  ``tokens_per_s`` counts every position
    (patches and frames included).  Returns ``(runs, misses)``: the caller
    holds the gate after emitting its record."""
    from repro_torch.kernels import ops
    from repro_torch.models import Model, ModelRuntime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tokens, patches, frames = batch["tokens"], batch.get("patches"), batch.get("frames")
    positions = tokens.numel() + sum(x.shape[0] * x.shape[1] for x in (patches, frames)
                                     if x is not None)

    def timed_loss(m, p) -> tuple:
        ms = []
        for _ in range(2):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            with torch.no_grad():
                loss = float(m.loss(p, batch)[0])
            e.record()
            torch.cuda.synchronize()
            ms.append(s.elapsed_time(e))
        return loss, min(ms)

    def logits(m, p) -> torch.Tensor:
        with torch.no_grad():
            return m.forward(p, tokens, patches=patches, frames=frames)[..., :cfg.vocab_size]

    plain_rt = dict(rt, attn_impl="chunked")
    with patched(ops, "rmsnorm", plain_rmsnorm):
        witness = logits(Model(cfg, ModelRuntime(**plain_rt)), params)
    runs, misses = [], []
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        p = params if dtype == torch.float32 else cast_params(params, dtype, "cuda")
        kern_model = Model(cfg, ModelRuntime(dtype=dtype, **rt))
        reset_launches()
        kern = logits(kern_model, p)
        launches = read_launches()
        require_exact_launches(cfg, launches, 1, f"{phase} {name}", flash=flash_per_forward(cfg))
        loss, forward_ms = timed_loss(kern_model, p)
        require(math.isfinite(loss) and bool(torch.isfinite(kern).all()),
                f"{phase} {name}: loss or logits not finite")
        run = {"dtype": name, "loss": loss, "forward_ms": forward_ms,
               "tokens_per_s": positions / (forward_ms / 1e3), "launches": launches,
               "from_f32_plain": {"max": (kern - witness).abs().max().item(),
                                  "mean": (kern - witness).abs().mean().item()}}
        if dtype == torch.float32:
            t = EVAL_LOGIT_TOL[dtype]
            run["gate"] = {"tol": t, "against_plain_max_abs": run["from_f32_plain"]["max"],
                           "worst_over_tol": worst_over(kern, witness, t)}
            if run["gate"]["worst_over_tol"] > 1.0:
                misses.append(f"f32 kernels against the plain path: {run['gate']}")
        else:
            with patched(ops, "rmsnorm", plain_rmsnorm):
                plain = logits(Model(cfg, ModelRuntime(dtype=dtype, **plain_rt)), p)
            run["bf16_plain_from_f32_plain"] = {"max": (plain - witness).abs().max().item(),
                                                "mean": (plain - witness).abs().mean().item()}
            del plain
        runs.append(run)
        del kern, p
    return runs, misses


def slice_eval(arch: str, batch: dict, phase: str) -> dict:
    """``eval_runs`` at ``SLICE_LAYERS``' depth (whole where unnamed),
    weights drawn on the card: the phase's
    record with its ``runs`` and ``misses``."""
    from repro_torch.configs import get_arch

    model = zoo_model(arch, SLICE_LAYERS.get(arch, get_arch(arch).n_layers), torch.float32)
    params, weights = zoo_weights(model)
    tokens = batch["tokens"]
    rec = {"phase": phase, "arch": arch, "weights": weights, "batch": list(tokens.shape),
           "seq_len": tokens.shape[1] + (model.cfg.n_vision_tokens if "patches" in batch else 0)}
    rec["runs"], rec["misses"] = eval_runs(phase, model.cfg, params, batch)
    del params
    release_device_memory()
    return rec


def phase_danube_eval() -> dict:
    """h2o-danube-3-4b at 12 of 24 layers over 1 x 8192 tokens of the eval runner's
    synthetic stream (``slice_eval``: flash at head width 120 with the
    4096 window, 12 flash and 25 RMSNorm a forward); then flash at BH 32 x
    8192, hd 120, window 4096 timed in both dtypes beside its bound (the
    windowed pair count at 120, not the padded 128), its plain version and
    SDPA given the window as a boolean mask, and causal at BH 32 x 512."""
    from repro_torch.configs import get_arch
    from repro_torch.train.data import DataConfig, SyntheticLM

    t_phase = time.perf_counter()
    cfg = get_arch(DANUBE_ARCH)
    batch = SyntheticLM(cfg, DataConfig(seq_len=DANUBE_EVAL_TOKENS, global_batch=1, seed=1234),
                        device="cuda").batch(0)
    rec = slice_eval(DANUBE_ARCH, batch, "danube_eval")
    rec["kernel_times"] = []
    for dtype in (torch.bfloat16, torch.float32):  # BH: 1 row of n_heads
        rec["kernel_times"].append(time_flash(cfg.n_heads, DANUBE_EVAL_TOKENS, dtype,
                                              hd=cfg.resolved_head_dim, window=DANUBE_WINDOW))
        release_device_memory()
    # the same width causal at S 512, under the window (the kernels case
    # hd120_causal_32x512)
    rec["kernel_times"] += [time_flash(cfg.n_heads, 512, dtype, hd=cfg.resolved_head_dim)
                            for dtype in (torch.bfloat16, torch.float32)]
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    require(not rec["misses"], "danube_eval: " + "; ".join(rec["misses"]))
    return rec


def phase_vlm_eval() -> dict:
    """internvl2-1b at 12 of 24 layers over 8 rows of 256 patches and 768
    tokens (S 1024)
    from ``SyntheticLM`` (``slice_eval``: flash at hd 64, 12 flash and 25
    RMSNorm at 896 a forward); then flash at BH 112 x 1024, hd 64, timed
    in both dtypes beside its bound, its plain version and SDPA."""
    from repro_torch.configs import get_arch
    from repro_torch.train.data import DataConfig, SyntheticLM

    t_phase = time.perf_counter()
    cfg = get_arch(VLM_ARCH)
    rows, text = VLM_EVAL_SHAPE
    batch = SyntheticLM(cfg, DataConfig(seq_len=text, global_batch=rows, seed=1234),
                        device="cuda").batch(0)
    require(batch["patches"].shape == (rows, cfg.n_vision_tokens, cfg.d_model),
            f"vlm_eval: patches of shape {tuple(batch['patches'].shape)}")
    rec = slice_eval(VLM_ARCH, batch, "vlm_eval")
    s = text + cfg.n_vision_tokens
    rec["kernel_times"] = [time_flash(rows * cfg.n_heads, s, dtype, hd=cfg.resolved_head_dim)
                           for dtype in (torch.bfloat16, torch.float32)]
    release_device_memory()
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    require(not rec["misses"], "vlm_eval: " + "; ".join(rec["misses"]))
    return rec


WHISPER_ARCH = "whisper-tiny"
# Full width and full depth everywhere (4 encoder and 4 decoder layers, d
# 384, 6 heads of 64, 1,500 frames; 50.1 M parameters): no cut.
# whisper_parity draws its f32 weights on the host (Model.init from seed
# 0, LayerNorm's w and b redrawn off 1 and 0 so a lost bias shows) and
# moves them to both devices through the bridge (params_to_jax, then
# params_from_jax); whisper_serve and whisper_eval draw on the card
# (Model.draw).
WHISPER_PARITY_KW = dict(max_batch=4, max_len=448, prefill_chunk=16, cache_mode="dense")
WHISPER_SERVE_KW = dict(max_batch=16, max_len=448, prefill_chunk=16, cache_mode="dense")
WHISPER_DECODE = (2, 32)  # whisper_parity (b): rows x tokens decoded over a filled cross cache
WHISPER_EVAL_SHAPE = (16, 448)  # rows x text tokens, each row over 1,500 frames
WHISPER_NORM_STD = 0.1
WHISPER_NORM_SEED = 1  # the numpy generator of the LayerNorm redraw


def whisper_model(dtype):
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime

    return Model(get_arch(WHISPER_ARCH), ModelRuntime(dtype=dtype))


def whisper_host_weights(model) -> tuple:
    """``(card tree, CPU tree, record)``: ``Model.init`` from seed 0 on the
    host, every LayerNorm's ``w`` and ``b`` redrawn around 1 and 0, then
    through the bridge (``params_to_jax``: the reference's stacked
    ``encoder.layers`` and ``cross``) and back (``params_from_jax``) onto
    each device."""
    from repro_torch.models.weights import params_from_jax, params_to_jax
    from repro_torch.tree import tree_leaves, tree_map_with_path

    rng = np.random.default_rng(WHISPER_NORM_SEED)
    host = model.init(0, device="cpu")

    def redraw(path, t):
        if path[-1] not in ("w", "b"):
            return t
        draw = torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
        return (draw * WHISPER_NORM_STD + (1.0 if path[-1] == "w" else 0.0)).to(t.dtype)

    bridged = params_to_jax(tree_map_with_path(redraw, host))
    card = params_from_jax(bridged, device="cuda", dtype=model.rt.dtype)
    cpu = params_from_jax(bridged, device="cpu", dtype=model.rt.dtype)
    leaves = tree_leaves(card)
    return card, cpu, {"init": "Model.init(0) on the host, LayerNorm w/b redrawn "
                               f"(std {WHISPER_NORM_STD}), through params_to_jax/params_from_jax",
                       "parameters": sum(t.numel() for t in leaves)}


def whisper_requests(vocab: int, n: int, lo: int, hi: int, new: int, seed: int):
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=f"w{i}", prompt=rng.integers(1, vocab, int(k)).tolist(),
                    max_new_tokens=new)
            for i, k in enumerate(rng.integers(lo, hi + 1, n))]


def fill_cross_cache(model, params, cache, frames) -> None:
    """The cross cache filled from the encoder as the reference's
    ``tests/test_arch_smoke.py`` fills it: ``_encode``, then each layer's
    K and V projections (not an engine feature, in either package)."""
    from repro_torch.models.layers import qkv_project

    cfg = model.cfg
    with torch.no_grad():
        enc = model._encode(params, frames)
        for i, cp in enumerate(params["cross"]):
            _, k, v = qkv_project(cp["attn"], enc, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.resolved_head_dim)
            cache["cross_k"][i].copy_(k)
            cache["cross_v"][i].copy_(v)


def whisper_decode(model, params, frames, tokens, device) -> tuple:
    """``decode_step`` over ``tokens`` ``(B, T)`` from a dense cache whose
    cross cache is filled from ``frames``: every step's logits ``(B, T,
    Vp)`` on the CPU, and the launches of the steps (the encoder's
    excluded)."""
    b, t = tokens.shape
    cache = model.init_cache(b, t, device=device)
    fill_cross_cache(model, params, cache, frames.to(device))
    reset_launches()
    out = []
    with torch.no_grad():
        for i in range(t):
            logits, cache = model.decode_step(params, cache, tokens[:, i:i + 1].to(device),
                                              torch.full((b,), i, device=device))
            out.append(logits.cpu())
    return torch.cat(out, dim=1), read_launches()


def phase_whisper_parity() -> dict:
    """whisper-tiny whole in f32 (TF32 off), weights from the host through
    the bridge (``whisper_host_weights``), card against CPU: (a) the dense
    engine on 4 requests (prompts 8-48, 16 new), every prompt ingested one
    token a decode dispatch: equal greedy tokens (the near-tie exception),
    every counter, every dispatch's logits at parity's 1e-4, exactly 4
    paged launches a dispatch (the cross attention of each decoder layer
    over the engine's zero cross cache), all on the decode path, and no
    other; (b) ``decode_step`` on 2 rows over a fixed 32-token sequence
    with the cross cache filled from ``SyntheticLM``'s 1,500 frames: each
    step's logits at 1e-4, 4 decode-path paged launches a step, and the
    distance from the teacher-forced forward reported; (c) one forward at
    2 x 448 over those frames: exactly 12 flash launches (4 encoder,
    non-causal over 1,500; 4 causal self; 4 cross, 448 x 1,500) and
    nothing else, its distance from the CPU's forward reported."""
    from repro_torch.train.data import DataConfig, SyntheticLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    model = whisper_model(torch.float32)
    cfg = model.cfg
    params, params_cpu, weights = whisper_host_weights(model)
    rec = {"phase": "whisper_parity", "arch": WHISPER_ARCH, "dtype": "float32",
           "weights": weights, "against": "the same calls on the CPU"}
    # (a) the dense engine
    reqs = lambda: whisper_requests(cfg.vocab_size, 4, 8, 48, 16, 12)  # noqa: E731
    reset_launches()
    gpu, gpu_s, gpu_calls = run_recorded(model, params, reqs(), "cuda", **WHISPER_PARITY_KW)
    launches = read_launches()
    cpu, cpu_s, cpu_calls = run_recorded(model, params_cpu, reqs(), "cpu", **WHISPER_PARITY_KW)
    what = "whisper_parity engine, card against CPU"
    divs = compare_greedy(model, params_cpu, gpu, cpu, what)
    require(gpu.prefill_dispatches == 0, f"{what}: a prompt took the fused prefill")
    require_exact_launches(cfg, launches, gpu.dispatches, what, paged=cfg.n_layers * gpu.dispatches)
    rec["engine"] = {"requests": 4, "knobs": WHISPER_PARITY_KW, "tokens_equal": not divs,
                     "divergences": divs,
                     "counters_card_cpu": compare_counters(gpu, cpu, what, MOE_COUNTERS),
                     "logits": compare_dispatch_logits(gpu_calls, cpu_calls, bool(divs), what),
                     "launches": launches,
                     "launches_per_dispatch": {k: v / gpu.dispatches
                                               for k, v in launches.items()},
                     "card_s": gpu_s, "cpu_s": cpu_s}
    # (b) decode over a cross cache filled from the frames
    b, t = WHISPER_DECODE
    batch = SyntheticLM(cfg, DataConfig(seq_len=t, global_batch=b, seed=21), device="cpu").batch(0)
    frames, tokens = batch["frames"], batch["tokens"]
    card, launches = whisper_decode(model, params, frames, tokens, "cuda")
    host, _ = whisper_decode(model, params_cpu, frames, tokens, "cpu")
    what = "whisper_parity decode over the filled cross cache, card against CPU"
    diff = (card - host).abs()
    ratio = float((diff / (PARITY_PARAM_ATOL + PARITY_RTOL * host.abs())).max())
    require_exact_launches(cfg, launches, t, what, paged=cfg.n_layers * t)
    with torch.no_grad():
        forced = model.forward(params_cpu, tokens, frames=frames)
    rec["decode"] = {"rows": b, "tokens": t, "frames": cfg.encoder_seq,
                     "max_abs_err": float(diff.max()), "worst_over_tolerance": ratio,
                     "launches": launches,
                     "from_teacher_forced_forward_max_abs": float((card - forced).abs().max())}
    require(ratio <= 1.0, f"{what}: logits {ratio}x past rtol {PARITY_RTOL} / atol "
            f"{PARITY_PARAM_ATOL}")
    # (c) one forward at 448 through the flash kernel
    s = WHISPER_EVAL_SHAPE[1]
    batch = SyntheticLM(cfg, DataConfig(seq_len=s, global_batch=2, seed=22), device="cpu").batch(0)
    reset_launches()
    with torch.no_grad():
        card = model.forward(params, batch["tokens"].cuda(), frames=batch["frames"].cuda())
        torch.cuda.synchronize()
        launches = read_launches()
        host = model.forward(params_cpu, batch["tokens"], frames=batch["frames"])
    what = "whisper_parity forward at 2 x 448"
    require_exact_launches(cfg, launches, 1, what, flash=flash_per_forward(cfg))
    rec["forward"] = {"batch": [2, s], "launches": launches,
                      "from_cpu_max_abs": float((card.cpu() - host).abs().max()),
                      "cpu_logits_max_abs": float(host.abs().max())}
    del params, params_cpu
    release_device_memory()
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def time_layernorm(rows: int, d: int, dtype) -> dict:
    """The plain LayerNorm (``layers.apply_norm``, as the reference
    computes it: no kernel of its own) at ``rows x d``: its device time
    and its byte bound (x read, the output written, w and b read once)."""
    from repro_torch.models.layers import apply_norm

    gen = torch.Generator(device="cuda").manual_seed(27)
    x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    p = {"w": torch.randn(d, generator=gen, device="cuda").to(dtype),
         "b": torch.randn(d, generator=gen, device="cuda").to(dtype)}
    item = x.element_size()
    return {"shape": {"rows": rows, "d": d}, "dtype": str(dtype).removeprefix("torch."),
            "ms": time_ms(lambda: apply_norm(p, x, "layernorm", 1e-5)),
            "bound_ms": (2 * rows * d + 2 * d) * item / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(lambda: torch.nn.functional.layer_norm(x, (d,), p["w"], p["b"])),
            "library_call": "F.layer_norm"}


def time_cross_cache(dtype) -> dict:
    """The paged kernel over whisper's cross cache at the serve shape
    (``cross_cache_inputs``: B 16, Hkv 6, G 1, 1,500 keys in pages of 20),
    held against its plain version and timed beside its bound (36.9 MB of
    K and V), the plain version and SDPA on the contiguous K/V (no mask:
    the pages gather nothing)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import (
        decode_plan,
        kernel_path,
        paged_flash_attention_folded,
        paged_flash_attention_folded_plain,
    )

    q, kp, vp, table, offs, (kc, vc) = cross_cache_inputs(dtype, seed=33)
    b, hkv, g, dk = q.shape
    scale = 1.0 / math.sqrt(dk)
    kern = lambda: paged_flash_attention_folded(  # noqa: E731
        q, kp, vp, table, offs, tokens_per_row=1, scale=scale)
    plain = lambda: paged_flash_attention_folded_plain(  # noqa: E731
        q, kp, vp, table, offs, tokens_per_row=1, scale=scale)
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    lib = lambda: F.scaled_dot_product_attention(q, kt, vt)  # noqa: E731
    path = kernel_path(dtype, g, dk, dk)
    nbytes, flops = paged_work(q, kp, table, offs, 1, dk)
    bms, by, _ = paged_route_bound(nbytes, flops, dtype, path)
    err = check_at_shape("paged attention (whisper cross cache)", kern, plain, dtype)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits, rounds = decode_plan(b, hkv, table.shape[1], kp.shape[1], dk, dk, q.element_size(),
                                 sms)
    return {"at": f"whisper_cross_{'f32' if dtype == torch.float32 else 'bf16'}",
            "shape": {"B": b, "Hkv": hkv, "G": g, "T": 1, "dk": dk, "keys": kc.shape[1],
                      "page_size": kp.shape[1], "pages_per_slot": table.shape[1]},
            "dtype": str(dtype).removeprefix("torch."), "path": path,
            "plan": {"splits": splits, "round_pages": rounds}, "max_abs_err": err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain), "bound_ms": bms, "bound_by": by,
            "bytes": nbytes, "library_ms": time_ms(lib),
            "library_call": "F.scaled_dot_product_attention on the contiguous cross cache"}


def phase_whisper_serve() -> dict:
    """whisper-tiny whole in bf16 on the dense engine, weights drawn on the
    card: 16 requests (prompts 16-64, 128 new, ``max_len`` 448, whisper's
    text context), every prompt ingested one token a decode dispatch; the
    cross cache (147.5 MB at 16 rows) is zero as the reference's engine
    leaves it, and the paged kernel reads all of it.  Tokens/s, dispatch
    wall median and p99, peak memory, exactly 4 decode-path paged launches
    a dispatch and nothing else launched; a traced decode dispatch (wall,
    busy, idle share, ops, the paged kernel's device time) and LayerNorm
    timed alone at the dispatch's 16 x 384 (13 a dispatch); the cross
    attention timed in both dtypes (``time_cross_cache``)."""
    from repro_torch.serving.engine import ServeEngine

    t_phase = time.perf_counter()
    model = whisper_model(torch.bfloat16)
    cfg = model.cfg
    params, weights = zoo_weights(model)
    kw = WHISPER_SERVE_KW
    run_engine(model, params, whisper_requests(cfg.vocab_size, 2, 16, 20, 4, 1), "cuda", **kw)
    reqs = whisper_requests(cfg.vocab_size, 16, 16, 64, 128, 13)
    eng = ServeEngine(model, params, device="cuda", **kw)
    eng._decode = DispatchTimer(eng._decode)
    eng.submit(reqs)
    release_device_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms = []
    t0 = time.perf_counter()
    while eng.pending or eng.scheduler.has_active():
        t_step = time.perf_counter()
        eng.step()
        step_ms.append((time.perf_counter() - t_step) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    name = "whisper_serve"
    outs = {r.uid: r.output for r in eng.finished}
    require(len(outs) == len(reqs) and all(
        len(o) == 128 and all(0 <= t < cfg.vocab_size for t in o) for o in outs.values()),
        f"{name}: a request did not finish with 128 tokens inside the vocab")
    require(eng.prefill_dispatches == 0, f"{name}: a prompt took the fused prefill")
    require_exact_launches(cfg, launches, eng.dispatches, name,
                           paged=cfg.n_layers * eng.dispatches)
    cross = eng.cache["cross_k"]
    d = eng.dispatches
    rec = {"phase": name, "arch": WHISPER_ARCH, "dtype": "bfloat16", "weights": weights,
           "knobs": kw, "requests": len(reqs), "prompt_tokens": [16, 64], "max_new_tokens": 128,
           "wall_s": wall, "tokens_emitted": eng.tokens_emitted,
           "tokens_per_s": eng.tokens_emitted / wall, "dispatches": d,
           "decode_dispatches": eng.decode_dispatches, "dispatch_wall_ms": summary(step_ms),
           "decode_dispatch_device_span_ms": summary(eng._decode.ms()),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "cross_cache_bytes": 2 * cross.numel() * cross.element_size(),
           "peak_cache_bytes": eng.peak_cache_bytes, "launches": launches,
           "launches_per_dispatch": {k: v / d for k, v in launches.items()}}
    del eng
    eng = ServeEngine(model, params, device="cuda", **kw)
    eng.submit(whisper_requests(cfg.vocab_size, 16, 256, 256, 64, 14))
    for _ in range(4):
        eng.step()
    d0 = eng.decode_dispatches
    profile = trace(eng.step, SLICE_TRACE_TICKS, "dispatch",
                    watch=("paged_decode_kernel", "gemm", "gemv", "nvjet"))
    require(eng.decode_dispatches - d0 == 2 * SLICE_TRACE_TICKS,
            f"{name}: traced ticks were not all decode dispatches")
    profile["paged_ms_per_dispatch"] = profile["watched_ops"]["paged_decode_kernel"][
        "ms_per_dispatch"]
    norm = time_layernorm(16, cfg.d_model, torch.bfloat16)
    norms = 3 * cfg.n_layers + 1  # ln1, the cross ln and ln2 a layer, then ln_f
    profile["layernorm"] = {"norms_per_dispatch": norms, "timed_alone": norm,
                            "ms_per_dispatch": norms * norm["ms"]}
    rec["profile"] = {"what": "decode dispatch, 16 rows, prompts 256", "ticks": SLICE_TRACE_TICKS,
                      **profile}
    del eng, params
    release_device_memory()
    rec["kernel_times"] = {"paged_attention": {
        t["at"]: t for t in (time_cross_cache(dt) for dt in (torch.bfloat16, torch.float32))}}
    for t in rec["kernel_times"]["paged_attention"].values():
        require(t["path"] == "decode", f"{name}: the cross cache {t['at']} took {t['path']}")
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def phase_whisper_eval() -> dict:
    """whisper-tiny whole over 16 x (1,500 frames + 448 tokens) from
    ``SyntheticLM``, weights drawn on the card (``eval_runs``: f32 through
    the kernels held at 1e-3 against the plain path, 12 flash launches a
    forward and no RMSNorm, a finite loss; bf16 timed and reported); then
    flash at each of its shapes timed in both dtypes beside its bound, its
    plain version and SDPA: the encoder (BH 96 x 1,500, non-causal), cross
    attention (BH 96 x 448 x 1,500, non-causal) and the decoder (BH 96 x
    448, causal)."""
    from repro_torch.train.data import DataConfig, SyntheticLM

    t_phase = time.perf_counter()
    model = whisper_model(torch.float32)
    cfg = model.cfg
    rows, text = WHISPER_EVAL_SHAPE
    batch = SyntheticLM(cfg, DataConfig(seq_len=text, global_batch=rows, seed=1234),
                        device="cuda").batch(0)
    require(batch["frames"].shape == (rows, cfg.encoder_seq, cfg.d_model),
            f"whisper_eval: frames of shape {tuple(batch['frames'].shape)}")
    params, weights = zoo_weights(model)
    rec = {"phase": "whisper_eval", "arch": WHISPER_ARCH, "weights": weights,
           "batch": [rows, text], "frames": cfg.encoder_seq}
    rec["runs"], rec["misses"] = eval_runs("whisper_eval", cfg, params, batch)
    del params
    release_device_memory()
    bh = rows * cfg.n_heads
    rec["kernel_times"] = [
        time_flash(bh, s, dtype, hd=cfg.resolved_head_dim, skv=skv, causal=causal)
        for s, skv, causal in ((cfg.encoder_seq, cfg.encoder_seq, False),
                               (text, cfg.encoder_seq, False), (text, text, True))
        for dtype in (torch.bfloat16, torch.float32)]
    release_device_memory()
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    require(not rec["misses"], "whisper_eval: " + "; ".join(rec["misses"]))
    return rec


# ------------------------------------------------------------------ training past ds-paper-100m
# family_train_parity: each family past ds-paper-100m trained at full width
# and a depth cut, card against CPU as train_parity does; remat_train:
# mamba2-1.3b under ModelRuntime(remat=True), at 6 layers against no remat
# and at all 48.
FAMILY_TRAIN_LAYERS = {SSM_ARCH: 1, HYBRID_ARCH: 7, MOE_ARCH: 1, MLA_ARCH: 1}
# mixtral's and deepseek's CPU steps took ~15 s each (AdamW over 1.7 and
# 1.4 B f32 parameters on the host): one step each, for the time limit;
# zamba2 keeps two, its lora_a moving only at step 2
FAMILY_TRAIN_STEPS = {SSM_ARCH: 2, HYBRID_ARCH: 2, MOE_ARCH: 1, MLA_ARCH: 1}
FAMILY_TRAIN_SHAPE = (2, 128)  # rows x tokens a step, train_parity's
REMAT_SHAPE = (2, 4096)
REMAT_PARITY_LAYERS = SSM_PARITY_LAYERS
REMAT_STEPS = 3
REMAT_RTOL = 1e-6  # remat against no remat: losses, and each leaf against its largest value


def forward_norms(cfg) -> int:
    """RMSNorm launches a full-sequence forward: ``hybrid_norms`` in the
    hybrid; ``ln1`` a layer in the SSM family; ``ln1`` and ``ln2`` a layer
    elsewhere, MLA's ``q_norm`` and ``kv_norm`` besides; and ``ln_f``.  A
    train step launches these once: its backward is plain torch."""
    if cfg.family == "hybrid":
        return hybrid_norms(cfg)
    per_layer = 1 if cfg.family == "ssm" else 4 if cfg.use_mla else 2
    return per_layer * cfg.n_layers + 1


def require_train_launches(launches: dict, norms: int, what: str) -> None:
    """A training run's exact launches: ``norms`` RMSNorm, all one-pass (the
    widths here, 512 to 5120, are compiled in), and no attention or SSD
    kernel: training takes the plain paths, as the reference does."""
    require(launches["rmsnorm"] == norms == launches["rmsnorm_one_pass"]
            and launches["ssd"] == 0 and launches["flash_attention"] == 0
            and launches["paged_attention"] == 0,
            f"{what}: launches {launches}, want {norms} one-pass RMSNorm and nothing else")


def phase_family_train_parity(ssm: tuple, hybrid: tuple) -> dict:
    """f32 train steps (TF32 off; ``FAMILY_TRAIN_STEPS``: two for mamba2 and
    zamba2, one for mixtral and deepseek) of each family past ds-paper-100m at
    full width, through the payload's ``build_model``/``build_train_step``
    and AdamW, on the card against the CPU from one tree: mamba2-1.3b's
    first layer and zamba2-1.2b's first 7 (one shared-block invocation
    with its LoRA, and a trailing layer) cut from ``ssm``/``hybrid`` (the
    host trees of ``ssm_weights``/``hybrid_weights``, zamba2's ``lora_b``
    back at the reference's zeros); mixtral-8x7b at 1 layer under
    ``capacity`` (the expert gather and the index backward run with
    atomics on the card) and deepseek-v2-236b's dense first layer (MLA's
    eight leaves and the 12,288-wide MLP), drawn on the card and copied to
    the host.  Held as ``train_parity`` holds ds-paper-100m: loss and
    grad_norm at each step, every parameter after the last, RMSNorm launches
    exact.  zamba2's zero ``lora_b`` leaves ``lora_a`` no gradient at step
    1, so it must move at step 2 past what weight decay alone gives."""
    from repro_torch.launch.train import build_model, build_train_step
    from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, seq = FAMILY_TRAIN_SHAPE
    rec = {"phase": "family_train_parity", "dtype": "float32", "tokens": f"{rows} x {seq}",
           "steps": FAMILY_TRAIN_STEPS, "rtol": PARITY_RTOL, "param_atol": PARITY_PARAM_ATOL,
           "cases": {},
           "launches": {}}
    for arch, layers in FAMILY_TRAIN_LAYERS.items():
        job = {"arch": arch, "arch_overrides": {"n_layers": layers}, "moe_strategy": "capacity"}
        model = build_model(job)
        release_device_memory()
        if arch in (SSM_ARCH, HYBRID_ARCH):
            _, host = first_layers(*(ssm if arch == SSM_ARCH else hybrid), layers)
            weights = {"from": "ssm_weights" if arch == SSM_ARCH else "hybrid_weights"}
            if arch == HYBRID_ARCH:
                shared = host["shared"]
                host = {**host, "shared": {**shared, "lora_b": torch.zeros_like(shared["lora_b"])}}
            card_init = tree_map(lambda t: t.to("cuda", copy=True), host)
        else:
            card_init, weights = zoo_weights(model)
            host = tree_map(lambda t: t.cpu(), card_init)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        steps = FAMILY_TRAIN_STEPS[arch]
        card, card_params = train_steps(job, "cuda", seq, rows, params=card_init, steps=steps)
        card_s = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        del card_init
        release_device_memory()
        t0 = time.perf_counter()
        cpu, cpu_params = train_steps(job, "cpu", seq, rows, params=host, steps=steps)
        cpu_s = time.perf_counter() - t0
        cpu_params = tree_map(lambda t: t.to("cuda"), cpu_params)  # compared on the card
        what = f"family_train_parity {arch}"
        worst, worst_leaf = 0.0, None
        for (path, a), b in zip(tree_leaves_with_path(card_params), tree_leaves(cpu_params)):
            err = (a - b).abs().max().item()
            if err >= worst:
                worst, worst_leaf = err, "/".join(map(str, path))
            require(bool(torch.allclose(a, b, atol=PARITY_PARAM_ATOL, rtol=PARITY_RTOL)),
                    f"{what}: {worst_leaf} differs after {steps} steps (max {err})")
        for step, (c, h) in enumerate(zip(card, cpu)):
            for key in ("loss", "grad_norm"):
                require(math.isfinite(c[key]) and abs(c[key] - h[key]) <= PARITY_RTOL * abs(h[key]),
                        f"{what}: {key} at step {step} card {c[key]} cpu {h[key]}")
        require_train_launches(launches, steps * forward_norms(model.cfg), what)
        case = {"layers": layers, "steps": steps, "weights": weights,
                "parameters": sum(t.numel() for t in tree_leaves(host)),
                "card": card, "cpu": cpu, "card_s": card_s, "cpu_s": cpu_s,
                "param_max_abs_err": worst, "worst_leaf": worst_leaf,
                "max_memory_allocated_bytes": peak,
                "tokens_per_s": rows * seq / (card[-1]["step_ms"] / 1e3),
                "rmsnorm_launches": launches["rmsnorm"]}
        if arch == HYBRID_ARCH:  # lora_a moved by its gradient at step 2, not by decay alone
            _, opt = build_train_step(job, model)
            decay = opt.weight_decay * (opt.schedule(1) + opt.schedule(2))
            a0 = host["shared"]["lora_a"].to("cuda")
            moved = {"card": (card_params["shared"]["lora_a"] - a0).abs().max().item(),
                     "cpu": (cpu_params["shared"]["lora_a"] - a0).abs().max().item()}
            by_decay = decay * a0.abs().max().item()
            require(min(moved.values()) > 10 * by_decay,
                    f"{what}: lora_a moved {moved} in 2 steps, weight decay alone {by_decay}")
            case["lora_a_moved"] = {**moved, "by_weight_decay_alone": by_decay}
        rec["cases"][arch] = case
        rec["launches"] = add_launches(rec["launches"], launches)
        del host, card_params, cpu_params
    release_device_memory()
    emit(rec)
    return rec


def saved_after_forward(model, params, batch) -> int:
    """Bytes one loss's forward leaves held on the card for its backward
    (the activations it saved and the logits): the allocator's growth
    across the forward, on fresh leaves with the gradient on."""
    from repro_torch.tree import tree_map

    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with torch.enable_grad():
        loss, _ = model.loss(leaves, batch)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    del loss, leaves
    return held


def remat_steps(cfg, host, remat: bool, steps: int, traced: bool = False) -> dict:
    """``steps`` f32 train steps of ``cfg`` on the card from the host tree
    ``host``, through ``make_train_step`` and ``init_opt_state`` (AdamW's
    defaults) under ``ModelRuntime(remat=remat)``, at ``REMAT_SHAPE``:
    each step's loss and wall ms, the parameters and optimizer state's
    bytes (``static_bytes``), the bytes a forward leaves held for its
    backward, the peak over the steps, the launches and the final tree;
    ``traced``: the last step under the profiler (``trace``, whose untraced
    rep is the step before it)."""
    from repro_torch import prng
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.steps import TrainStepConfig, make_train_step

    rows, seq = REMAT_SHAPE
    model = Model(cfg, ModelRuntime(remat=remat))
    tcfg = TrainStepConfig()
    step_fn = make_train_step(model, tcfg)
    data = SyntheticLM(cfg, DataConfig(seq_len=seq, global_batch=rows), device="cuda")
    release_device_memory()
    state = {"params": cast_params(host, torch.float32, "cuda")}
    state["opt"] = init_opt_state(state["params"], tcfg.opt)
    torch.cuda.synchronize()
    static = torch.cuda.memory_allocated()
    saved = saved_after_forward(model, state["params"], data.batch(0))
    release_device_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms = [], []

    def one_step():
        i = len(losses)
        t0 = time.perf_counter()
        state["params"], state["opt"], met = step_fn(state["params"], state["opt"],
                                                     data.batch(i), prng.PRNGKey(i, device="cuda"))
        losses.append(float(met["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)

    for _ in range(steps - 2 if traced else steps):
        one_step()
    profile = trace(one_step, 1, "step") if traced else None
    out = {"remat": remat, "layers": cfg.n_layers, "losses": losses, "step_ms": step_ms,
           "static_bytes": static, "saved_after_forward_bytes": saved,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": read_launches(), "params": state["params"]}
    if traced:
        out["profile"] = {"what": f"f32 train step under remat, {rows} x {seq} tokens, "
                                  f"{cfg.n_layers} layers (the last step)", **profile}
    return out


def tree_gap(a, b) -> dict:
    """Leaf by leaf: the largest gap against the leaf's largest value in
    ``b``, and the leaves that are not bit-equal."""
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    worst, differ = 0.0, []
    for (path, x), y in zip(tree_leaves_with_path(a), tree_leaves(b)):
        if not torch.equal(x, y):
            differ.append("/".join(map(str, path)))
            scale = max(y.abs().max().item(), 1e-30)
            worst = max(worst, (x - y).abs().max().item() / scale)
    return {"worst_rel_to_leaf_max": worst, "not_bit_equal": differ}


def phase_remat_train(cfg, params_cpu) -> dict:
    """mamba2-1.3b trained in f32 (TF32 off) under ``ModelRuntime(remat=
    True)`` through ``make_train_step``, at REMAT_SHAPE (2 x 4096 tokens).
    (a) Its first 4 layers, 2 steps with remat against 2 without, on the
    card: losses and every parameter equal within REMAT_RTOL (where not bit
    for bit, a second run without remat says whether an op is
    nondeterministic run to run), the peak lower with remat, RMSNorm
    launched again in the recompute (each layer's ``ln1``, exact), no SSD
    kernel (training takes the plain scan); the bytes a forward leaves held
    give the per-layer activation bytes.  (b) All 48 layers, 3 steps with
    remat (the last traced): finite losses, exact launches, step ms,
    tokens/s and the peak; the peak without remat is not run, only
    predicted from (a)'s per-layer bytes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, seq = REMAT_SHAPE
    cut_cfg, cut = first_layers(cfg, params_cpu, REMAT_PARITY_LAYERS)
    rec = {"phase": "remat_train", "arch": cfg.name, "dtype": "float32",
           "tokens": f"{rows} x {seq}", "rtol": REMAT_RTOL, "launches": {}}
    runs = {}
    for name, remat in (("no_remat", False), ("remat", True)):
        out = remat_steps(cut_cfg, cut, remat, 2)
        norms = 2 * (forward_norms(cut_cfg) + (cut_cfg.n_layers if remat else 0))
        require_train_launches(out["launches"], norms, f"remat_train {name}")
        rec["launches"] = add_launches(rec["launches"], out["launches"])
        runs[name] = out
    a, b = runs["remat"], runs["no_remat"]
    gap = tree_gap(a["params"], b["params"])
    gap["losses"] = [(x, y) for x, y in zip(a["losses"], b["losses"])]
    if gap["not_bit_equal"] or a["losses"] != b["losses"]:  # remat, or an op run to run?
        again = remat_steps(cut_cfg, cut, False, 2)
        gap["no_remat_run_to_run"] = {**tree_gap(again["params"], b["params"]),
                                      "losses_equal": again["losses"] == b["losses"]}
        del again
    for name in runs:
        runs[name].pop("params")
    release_device_memory()
    require(all(abs(x - y) <= REMAT_RTOL * abs(y) for x, y in gap["losses"])
            and gap["worst_rel_to_leaf_max"] <= REMAT_RTOL,
            f"remat_train: remat against no remat {gap}")
    require(a["max_memory_allocated_bytes"] < b["max_memory_allocated_bytes"],
            f"remat_train: peak {a['max_memory_allocated_bytes']} with remat, "
            f"{b['max_memory_allocated_bytes']} without")
    boundary = rows * seq * cfg.d_model * 4  # a checkpoint's input, what remat keeps a layer
    per_layer = (b["saved_after_forward_bytes"] - a["saved_after_forward_bytes"]) / \
        REMAT_PARITY_LAYERS + boundary
    full = remat_steps(cfg, params_cpu, True, REMAT_STEPS, traced=True)
    full.pop("params")
    release_device_memory()
    require(len(full["losses"]) == REMAT_STEPS
            and all(math.isfinite(x) for x in full["losses"]),
            f"remat_train: full-depth losses {full['losses']}")
    require_train_launches(full["launches"],
                           REMAT_STEPS * (forward_norms(cfg) + cfg.n_layers),
                           "remat_train full depth")
    rec["launches"] = add_launches(rec["launches"], full["launches"])
    untraced = full["step_ms"][:-1]
    predicted = full["saved_after_forward_bytes"] + cfg.n_layers * (per_layer - boundary)
    rec.update({
        "cut": {"layers": REMAT_PARITY_LAYERS, **runs, "remat_against_no_remat": gap,
                "per_layer_saved_bytes": {"no_remat": per_layer, "remat": boundary}},
        "full_depth": {**full, "step_ms_untraced": summary(untraced),
                       "tokens_per_s": rows * seq / (summary(untraced)["median"] / 1e3)},
        "predicted_no_remat_full_depth": {
            "what": "a prediction, not run: the bytes a 48-layer forward without remat "
                    "would leave held (the remat forward's plus 48 x (a) per-layer bytes "
                    "less the boundary), and with the parameters and AdamW state, a lower "
                    "bound on its peak",
            "saved_after_forward_bytes": predicted,
            "peak_lower_bound_bytes": full["static_bytes"] + predicted},
        "device": smi_line()})
    emit(rec)
    return rec



# The mesh: the card's machine has one H100, so its mesh is (1, 1)
# over NCCL: the run shows that the DTensor path reaches the hand-written
# kernels and gives what the plain path gives; the multi-rank arithmetic
# is held on the CPU (tests/test_torch_distribution.py and friends).
MESH_ARCH = "ds-paper-100m"
MESH_LAYERS = 2  # of its 12, at full width (12 x 768)
MESH_TRAIN_SHAPE = (2, 128)  # rows x tokens
MESH_EVAL_SHAPE = (2, 512)  # flash's block: the eval forward takes the kernel
MESH_MOE_SHAPE = (2, 128)  # tokens through one full-width mixtral-8x7b layer
MESH_PIPE = (8, 2)  # microbatches x rows through a one-stage pipe at d 768
MESH_MOE_OUT_TOL = 2e-5
MESH_MOE_GRAD_RTOL = 1e-4  # of each leaf's largest gradient


def mesh_world(root: Path) -> float:
    """A one-rank NCCL group on the card through a ``FileStore`` (its
    address given, as nothing on the machine names a cluster); the
    seconds until its first all-reduce returns.  A failed start raises."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(str(root / "nccl_store"), 1), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    one = torch.ones(1, device="cuda")
    dist.all_reduce(one)
    torch.cuda.synchronize()
    require(one.item() == 1.0, f"mesh: all-reduce over one rank gave {one.item()}")
    return time.perf_counter() - t0


def gap_to(a: torch.Tensor, b: torch.Tensor) -> dict:
    return {"bit_equal": bool(torch.equal(a, b)), "max_abs_err": (a - b).abs().max().item(),
            "ref_max": b.abs().max().item()}


def phase_mesh(root: Path) -> dict:
    """The model over a (1, 1) ("data", "model") DeviceMesh on the card
    (NCCL, one rank) under ``train_rules``, FSDP over "data", every
    parameter a DTensor laid out by ``param_specs``, against the same model
    run unsharded on the card: (a) ds-paper-100m at full width, 2 layers,
    f32 (TF32 off): the loss and every leaf's gradient, RMSNorm forward
    (the kernel, through ``local_map``) and backward; (b) its bf16 eval
    forward: logits, flash and RMSNorm launches; (c) one full-width
    mixtral-8x7b layer in f32, ``shardmap`` (the expert-parallel layer:
    all-to-alls and gathers over one rank) against ``capacity``: output at
    2e-5, gradients at 1e-4 of each leaf's largest; (d) ``pipeline_apply``
    on a one-stage pipe at d 768 against the stage run directly.  A mesh
    of another size than the world raises.  Launches by kernel path are
    equal between each sharded run and its unsharded one."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import Model, ModelRuntime, moe
    from repro_torch.sharding import (
        PartitionSpec as P,
        ShardingPolicy,
        axis_rules,
        distribute_params,
        param_specs,
        spec_placements,
        train_rules,
    )
    from repro_torch.train.pipeline import pipeline_apply
    from repro_torch.train.steps import _value_and_grad
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {"phase": "mesh", "arch": MESH_ARCH, "layers": MESH_LAYERS, "mesh": "(1, 1) data x model",
           "backend": "nccl", "rules": "train_rules, fsdp_axes=('data',)", "launches": {}}
    rec["nccl_start_s"] = mesh_world(root)
    try:
        try:
            make_test_mesh((2, 1), ("data", "model"))
            raise CheckFailed("mesh: a (2, 1) mesh over a world of 1 was built")
        except ValueError as e:
            rec["wrong_world_raises"] = str(e)
        mesh = make_test_mesh((1, 1), ("data", "model"))
        rules = train_rules(multi_pod=False)

        def full(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        def place(params):
            specs, _ = param_specs(params, mesh, ShardingPolicy(fsdp_axes=("data",)))
            return distribute_params(params, mesh, specs)

        def rows(t):
            return distribute_tensor(t, mesh, spec_placements(P("data", *([None] * (t.dim() - 1))),
                                                              mesh))

        # (a) training: the loss and every gradient
        cfg = dataclasses.replace(get_arch(MESH_ARCH), n_layers=MESH_LAYERS)
        model = Model(cfg, ModelRuntime())
        params = init_params(model, 0, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(32)
        b, s = MESH_TRAIN_SHAPE
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1), device="cuda", generator=gen)
        batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}

        def ruled(fn):
            def run(p, bt):
                with axis_rules(mesh, rules):
                    return fn(p, bt)
            return run

        runs = {}
        for name, (p, bt, fn) in {
                "plain": (params, batch, model.loss),
                "mesh": (place(params), {k: rows(v) for k, v in batch.items()},
                         ruled(model.loss))}.items():
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            loss, grads = _value_and_grad(fn, p, bt)
            loss = float(full(loss))
            grads = [full(g) for g in tree_leaves(grads)]
            torch.cuda.synchronize()
            runs[name] = {"loss": loss, "grads": grads, "launches": read_launches(),
                          "ms": (time.perf_counter() - t0) * 1e3}
        plain, mesh_run = runs["plain"], runs["mesh"]
        worst, differ = 0.0, []
        for (path, _), a, g in zip(tree_leaves_with_path(params), mesh_run["grads"],
                                   plain["grads"]):
            if not torch.equal(a, g):
                differ.append("/".join(map(str, path)))
            rel = (a - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
            worst = max(worst, rel)
        train = {"loss": [mesh_run["loss"], plain["loss"]], "grads_not_bit_equal": differ,
                 "grad_worst_rel_to_leaf_max": worst,
                 "ms": [mesh_run["ms"], plain["ms"]], "launches": mesh_run["launches"],
                 "launches_plain": plain["launches"]}
        require(abs(mesh_run["loss"] - plain["loss"]) <= PARITY_RTOL * abs(plain["loss"])
                and worst <= PARITY_RTOL,
                f"mesh (a): sharded loss/gradients against plain {train}")
        require(mesh_run["launches"] == plain["launches"]
                and plain["launches"]["rmsnorm"] == forward_norms(cfg),
                f"mesh (a): launches {mesh_run['launches']} against {plain['launches']}")
        rec["train"] = train
        rec["launches"]["train"] = mesh_run["launches"]
        del runs, plain, mesh_run

        # (b) the bf16 eval forward: flash and RMSNorm through local_map
        emodel = Model(cfg, ModelRuntime(dtype=torch.bfloat16))
        eparams = cast_params(params, torch.bfloat16, "cuda")
        eb, es = MESH_EVAL_SHAPE
        etoks = torch.randint(0, cfg.vocab_size, (eb, es), device="cuda", generator=gen)
        outs = {}
        for name, (p, t, fn) in {
                "plain": (eparams, etoks, emodel.forward),
                "mesh": (place(eparams), rows(etoks), ruled(emodel.forward))}.items():
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits = full(fn(p, t))
            torch.cuda.synchronize()
            outs[name] = {"logits": logits, "launches": read_launches(),
                          "ms": (time.perf_counter() - t0) * 1e3}
        ev = {**gap_to(outs["mesh"]["logits"], outs["plain"]["logits"]),
              "finite": bool(torch.isfinite(outs["mesh"]["logits"]).all()),
              "ms": [outs["mesh"]["ms"], outs["plain"]["ms"]],
              "launches": outs["mesh"]["launches"], "launches_plain": outs["plain"]["launches"]}
        require(ev["finite"] and ev["max_abs_err"] <= EVAL_LOGIT_TOL[torch.bfloat16],
                f"mesh (b): sharded bf16 logits against plain {ev}")
        require(ev["launches"] == ev["launches_plain"]
                and ev["launches"]["flash_attention"] == MESH_LAYERS
                and ev["launches"]["rmsnorm"] == forward_norms(cfg),
                f"mesh (b): launches {ev['launches']} against {ev['launches_plain']}")
        rec["eval"] = ev
        rec["launches"]["eval"] = outs["mesh"]["launches"]
        del outs, eparams, params
        release_device_memory()

        # (c) one full-width mixtral-8x7b layer: shardmap against capacity
        mcfg = get_arch(MOE_ARCH)

        def normal(shape, std, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="cuda").normal_(0.0, std, generator=gen)

        mp = moe.moe_param_tree(mcfg, normal, None, 1.0 / math.sqrt(2 * mcfg.n_layers))
        x = normal((*MESH_MOE_SHAPE, mcfg.d_model), 1.0)
        res = {}
        for name, (p, xx, fn) in {
                "capacity": ({k: v.clone().requires_grad_(True) for k, v in mp.items()}, x,
                             lambda p, xx: moe.apply_moe(p, xx, mcfg, "capacity")),
                "shardmap": (place({k: v.clone() for k, v in mp.items()}), rows(x),
                             ruled(lambda p, xx: moe.apply_moe(p, xx, mcfg, "shardmap")))}.items():
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(leaves, xx)
            gs = torch.autograd.grad((y.float() ** 2).sum(), [leaves[k] for k in sorted(leaves)])
            res[name] = {"y": full(y).detach(), "grads": [full(g) for g in gs]}
            torch.cuda.synchronize()
            res[name]["ms"] = (time.perf_counter() - t0) * 1e3
        a, c = res["shardmap"], res["capacity"]
        moe_rec = {"tokens": "x".join(map(str, MESH_MOE_SHAPE)), "out": gap_to(a["y"], c["y"]),
                   "grads": {k: {**gap_to(ga, gc),
                                 "rel_to_leaf_max": (ga - gc).abs().max().item()
                                 / max(gc.abs().max().item(), 1e-30)}
                             for k, ga, gc in zip(sorted(mp), a["grads"], c["grads"])},
                   "ms": [a["ms"], c["ms"]]}
        require(moe_rec["out"]["max_abs_err"] <= MESH_MOE_OUT_TOL
                and all(g["rel_to_leaf_max"] <= MESH_MOE_GRAD_RTOL
                        for g in moe_rec["grads"].values()),
                f"mesh (c): shardmap against capacity {moe_rec}")
        rec["moe"] = moe_rec
        del res, a, c, mp, x
        release_device_memory()

        # (d) GPipe on a one-stage pipe
        pipe = make_test_mesh((1,), ("pipe",))
        m, mb = MESH_PIPE
        d = cfg.d_model
        w = normal((1, d, d), 1.0 / math.sqrt(d))
        bias = normal((1, d), 0.1)
        xs = normal((m, mb, d), 1.0)

        def stage(p, h):
            return torch.tanh(h @ p["w"] + p["b"])

        got = pipeline_apply(pipe, {"w": w, "b": bias}, xs, stage)
        want = stage({"w": w[0], "b": bias[0]}, xs)
        rec["pipeline"] = {"microbatches": m, "rows": mb, "d": d, **gap_to(got, want)}
        require(rec["pipeline"]["max_abs_err"] <= F32_TOL,
                f"mesh (d): pipeline against the stage {rec['pipeline']}")
    finally:
        dist.destroy_process_group()
    release_device_memory()
    rec["device"] = smi_line()
    emit(rec)
    return rec

ROOFLINE_ARCH = "ds-paper-100m"
ROOFLINE_SHAPE = "serve_paged_32k"  # B 128, max_len 32,768, pages of 128, a pool of 16,384
ROOFLINE_DEPTHS = (2, 4, 12)  # the probes' pair, then full depth
ROOFLINE_ORDER = (12, 2, 4)  # full depth first, while the card's memory is whole
ROOFLINE_WARMUP = 3
ROOFLINE_STEPS = 25  # timed decode steps a depth (the median is kept)
ROOFLINE_MAX_SHARE = 1.05  # bound / measured above this: the count is wrong
ROOFLINE_SEED = 0
# the paged kernel at the cell's shape: its max error within this share of
# the largest output (bf16 rounds an output to within 2^-9 of it)
ROOFLINE_PAGED_REL = 1 / 64


def roofline_inputs(cell, gen) -> tuple:
    """The cell's inputs on the card: parameters drawn by ``gen``, the K/V
    pools random, every row at position 16,383 holding 128 distinct pages
    of its own (the pool exactly full), random tokens."""
    from repro_torch.launch.cells import SERVE_PAGE_SIZE

    model, shape = cell.model, cell.shape
    b = shape.global_batch
    n_pages = cell.args[1]["k_pages"].shape[1]
    per_row = n_pages // b
    # the pools first, into memory no smaller allocation has split
    cache = model.init_cache(b, shape.seq_len, paged=True, page_size=SERVE_PAGE_SIZE,
                             n_pages=n_pages, device="cuda")
    params = model.draw(gen)
    for name in ("k_pages", "v_pages"):
        cache[name].normal_(generator=gen)
    cache["page_table"][:, :per_row] = torch.arange(
        n_pages, dtype=torch.int32, device="cuda").view(b, per_row)
    tokens = torch.randint(0, cell.cfg.vocab_size, (b, 1), generator=gen, device="cuda",
                           dtype=torch.int32)
    pos = torch.full((b,), per_row * SERVE_PAGE_SIZE - 1, dtype=torch.int32, device="cuda")
    return params, cache, tokens, pos


def paged_check_at_scale(got, q, kp, vp, table, pos, kw) -> dict:
    """Hold the paged kernel's output ``got`` at the roofline cell's shape
    against its plain version, to ``ROOFLINE_PAGED_REL`` of the largest
    output: each output is a softmax mean over 16,384 keys, so the outputs
    spread about 0.013, below the bf16 check's absolute 2e-2.  The check
    is then shown to fail the plain version run on the table with one page
    a row left out, and with one split's pages a row left out (the decode
    path's ``decode_plan`` at this shape): what a kernel that skipped them
    would return."""
    from repro_torch.kernels import flash_decode

    n_pages, width = kp.shape[0], table.shape[1]
    want = flash_decode.paged_flash_attention_folded_plain(q, kp, vp, table, pos, **kw).float()
    limit = ROOFLINE_PAGED_REL * want.abs().max().item()
    err = (got.float() - want).abs().max().item()
    require(bool(torch.isfinite(got).all()) and err <= limit,
            f"roofline: paged attention off its plain version by {err} (limit {limit})")
    b, hkv, _, dk = q.shape
    splits, _ = flash_decode.decode_plan(b, hkv, width, kp.shape[1], dk, vp.shape[-1],
                                         q.element_size(), flash_decode._sm_count(q.device.index))
    per_split = -(-width // splits)
    rows = torch.arange(b, device=q.device)
    resident = int((table[0] < n_pages).sum())
    page = table.clone()
    page[rows, rows % resident] = n_pages  # one resident page a row, a different one each row
    split = table.clone()
    split[:, :per_split] = n_pages  # the first split's pages, every row
    dropped = {}
    for what, cut in (("one_page_a_row", page), ("one_split_a_row", split)):
        wrong = flash_decode.paged_flash_attention_folded_plain(q, kp, vp, cut, pos, **kw)
        dropped[what] = (wrong.float() - want).abs().max().item()
        require(dropped[what] > limit,
                f"roofline: the check at scale passes the output with {what} dropped "
                f"({dropped[what]} within {limit})")
    return {"max_abs_err": err, "limit": limit, "rel_limit": ROOFLINE_PAGED_REL,
            "max_abs_want": limit / ROOFLINE_PAGED_REL, "splits": splits,
            "pages_a_split": per_split, "dropped_max_abs_err": dropped}


def roofline_kernels_at_shape(cell, params, cache, tokens, pos) -> dict:
    """The paged kernel and RMSNorm at the cell's own shapes (layer 0's
    pool, B 128, 128 pages of 128 a row, d 768) against their plain
    versions, and the paged kernel timed beside its bound, its plain
    version and SDPA on the pages gathered to a contiguous cache."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import (
        paged_flash_attention_folded,
        paged_flash_attention_folded_plain,
    )
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    cfg = cell.cfg
    b, hkv, dk = tokens.shape[0], cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(ROOFLINE_SEED + 1)
    q = torch.randn((b, hkv, 1, dk), generator=gen, device="cuda").to(torch.bfloat16)
    kp, vp, table = cache["k_pages"][0], cache["v_pages"][0], cache["page_table"]
    kw = dict(tokens_per_row=1, scale=1.0 / math.sqrt(dk))

    def kern():
        return paged_flash_attention_folded(q, kp, vp, table, pos, **kw)

    def plain():
        return paged_flash_attention_folded_plain(q, kp, vp, table, pos, **kw)

    rec = {"paged_attention": {"shape": {"B": b, "Hkv": hkv, "dk": dk, "page": kp.shape[1],
                                         "pages_a_row": int((table[0] < kp.shape[0]).sum()),
                                         "pool_pages": kp.shape[0]}}}
    rec["paged_attention"].update(paged_check_at_scale(kern(), q, kp, vp, table, pos, kw))
    release_device_memory()
    nbytes, flops = paged_work(q, kp, table, pos, 1, dk)
    bound_ms, bound_by = bound(nbytes, flops, torch.bfloat16)
    ms = time_ms(kern)
    plain_ms = time_ms(plain, iters=5)
    release_device_memory()
    # yardstick: SDPA on K/V pre-gathered to a contiguous (B, H, P*ps, dk)
    # cache with a boolean mask (the gather is not timed)
    n_pages, ps = kp.shape[0], kp.shape[1]
    keys = table.shape[1] * ps
    safe = table.long().clamp(max=n_pages - 1)
    kc = kp[safe].reshape(b, keys, hkv, dk).transpose(1, 2).contiguous()
    vc = vp[safe].reshape(b, keys, hkv, dk).transpose(1, 2).contiguous()
    alloc = torch.repeat_interleave(table < n_pages, ps, dim=1)
    mask = ((torch.arange(keys, device="cuda")[None] <= pos.long()[:, None]) & alloc)[:, None, None]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask),
                         iters=10)
    del kc, vc, mask, alloc, safe
    release_device_memory()
    rec["paged_attention"].update(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                                  share=bound_ms / ms, plain_ms=plain_ms,
                                  library_ms=library_ms)
    x = torch.randn((b, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    w = params["ln_f"]["w"]
    rec["rmsnorm"] = {"shape": {"rows": b, "d": cfg.d_model}, "max_abs_err": check_at_shape(
        "roofline: rmsnorm", lambda: rmsnorm(x, w, cfg.norm_eps),
        lambda: rmsnorm_plain(x, w, cfg.norm_eps), torch.bfloat16)}
    return rec


def roofline_depth(mesh, layers: int, gen, kernels: bool) -> dict:
    """One depth of the roofline phase: the count, the fit, the inputs'
    bytes, the launches, the peak and the timed steps."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import build_cell, trace_cell
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_arch(ROOFLINE_ARCH), n_layers=layers)
    t0 = time.perf_counter()
    cell = build_cell(ROOFLINE_ARCH, ROOFLINE_SHAPE, mesh, cfg_override=cfg)
    traced = trace_cell(cell, mesh)
    fit = dryrun.cell_report(cell, traced, mesh, time.perf_counter() - t0)
    rec = {"layers": layers, "fits": fit["memory"]["fits"],
           "projected_gib": fit["memory"]["projected_gib"],
           "state_gib_analytic": fit["memory"]["state_gib_analytic"],
           "traced_temp_gib": fit["memory"]["temp_gib"],
           "card_gib": fit["memory"]["card_gib"], "free_gib": torch.cuda.mem_get_info()[0] / GIB,
           "reserved_gib": torch.cuda.memory_reserved() / GIB,
           "allocated_gib": torch.cuda.memory_allocated() / GIB}
    require(rec["fits"], f"roofline: {layers} layers do not fit the card: {fit['memory']}")
    rr = dryrun.cell_roofline(cell, traced, mesh)
    rec["count"] = {"flops": rr.flops, "bytes": rr.bytes, "bytes_jnp": rr.bytes_jnp,
                    "compute_s": rr.compute_s, "memory_s": rr.memory_s, "bound_s": rr.bound_s,
                    "dominant": rr.dominant, "model_flops_global": rr.model_flops_global}

    # (a) the inputs' bytes on the card against the analytic count, exactly:
    # the allocator's requested bytes (its blocks round up, and a cached
    # block it does not split counts whole in memory_allocated)
    def requested() -> int:
        torch.cuda.synchronize()
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    before = requested()
    params, cache, tokens, pos = roofline_inputs(cell, gen)
    analytic = dryrun._analytic_arg_bytes(cell, mesh)
    rec["input_bytes"] = {"allocated": requested() - before, "analytic": analytic}
    require(rec["input_bytes"]["allocated"] == analytic,
            f"roofline: inputs at {layers} layers allocated {rec['input_bytes']}")
    # the count's bytes no fewer than the step must read: both pools (every
    # page resident) and every weight once (the embedding table only where
    # it is the head: the step gathers 128 of its rows)
    weights = {k: v for k, v in params.items() if k != "embed" or cfg.tie_embeddings}
    rec["count"]["floor_bytes"] = (cache["k_pages"].nbytes + cache["v_pages"].nbytes
                                   + sum(t.nbytes for t in tree_leaves(weights)))
    require(rr.bytes >= rec["count"]["floor_bytes"],
            f"roofline: the count's {rr.bytes} bytes at {layers} layers miss the "
            f"{rec['count']['floor_bytes']} the step must read")
    if kernels:
        rec["kernels_at_shape"] = roofline_kernels_at_shape(cell, params, cache, tokens, pos)

    def step():
        with torch.no_grad():
            return cell.model.decode_step(params, cache, tokens, pos)[0]

    for _ in range(ROOFLINE_WARMUP):
        logits = step()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (
        tokens.shape[0], 1, cfg.padded_vocab), f"roofline: logits {tuple(logits.shape)}")
    del logits
    # (e) the launches of one step
    reset_launches()
    step()
    torch.cuda.synchronize()
    rec["launches"] = read_launches()
    want = {"paged_attention": layers, "paged_attention_decode": layers,
            "rmsnorm": 2 * layers + 1, "rmsnorm_one_pass": 2 * layers + 1}
    require(all(rec["launches"][k] == n for k, n in want.items()),
            f"roofline: launches at {layers} layers {rec['launches']}, want {want}")
    # (b) the step's peak against the projection
    release_device_memory()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rec["peak"] = {"max_memory_allocated_gib": peak / GIB, "projected_gib": rec["projected_gib"],
                   "step_gib": (peak - base) / GIB, "traced_temp_gib": rec["traced_temp_gib"]}
    # (c, d) the timed steps against the count's bound
    times = []
    for _ in range(ROOFLINE_STEPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        step()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    rec["step_ms"] = summary(times)
    ms = rec["step_ms"]["median"]
    rec["share"] = rr.bound_s * 1e3 / ms
    require(rec["share"] <= ROOFLINE_MAX_SHARE,
            f"roofline: bound {rr.bound_s * 1e3} ms over measured {ms} ms at {layers} layers")
    del params, cache, tokens, pos
    release_device_memory()
    return rec


def phase_roofline() -> dict:
    """ds-paper-100m's ``serve_paged_32k`` decode step at full width (12
    heads of 64, d 768, vocab 32,768, B 128, max_len 32,768, pages of
    128, a pool of 16,384) on the card's one rank (a (1, 1) "data" x
    "model" layout, which splits nothing: the step runs on the plain
    tensors, no DTensor copy of the 72 GiB pool), at the probes' depths 2
    and 4 and at full depth 12, against the port's own count of it
    (``launch.dryrun``): for each depth (a) the inputs' bytes on the card
    against ``_analytic_arg_bytes``, exactly; (b) ``max_memory_allocated``
    over a step against the projection; (c) the count's compute, memory
    and bound, its bytes no fewer than the pools and weights the step
    must read; (d) the median of 25 steps (CUDA events, after 3 warm-up
    steps) and the share bound / measured, at most 1.05; (e) the paged
    kernel's launches L and RMSNorm's 2L + 1 over one step; then (f) the
    reference's differencing (``extrapolate``: a layer's cost from 2 and 4
    layers, carried to 12) applied to the measured times, and to the
    count's bounds, against those at 12.  Full depth runs first, while no
    smaller allocation has split the card's memory.  At 2 layers the
    paged kernel and RMSNorm are held against their plain versions at the
    cell's shapes."""
    release_device_memory()
    rec = {"phase": "roofline", "arch": ROOFLINE_ARCH, "shape": ROOFLINE_SHAPE,
           "mesh": "(1, 1) data x model", "depths": {}}
    launches = {}
    mesh = {"data": 1, "model": 1}
    gen = torch.Generator(device="cuda").manual_seed(ROOFLINE_SEED)
    for layers in ROOFLINE_ORDER:
        d = roofline_depth(mesh, layers, gen, kernels=layers == ROOFLINE_DEPTHS[0])
        rec["depths"][layers] = d
        launches = {k: launches.get(k, 0) + n for k, n in d["launches"].items()}
    # (f) the reference's differencing on the card's clock, and on the count
    l1, l2, full = ROOFLINE_DEPTHS
    rec["extrapolated"] = {}
    for key, read in (("ms", lambda d: d["step_ms"]["median"]),
                      ("bound_ms", lambda d: d["count"]["bound_s"] * 1e3)):
        at1, at2, at_full = (read(rec["depths"][n]) for n in (l1, l2, full))
        predicted = at1 + (at2 - at1) / (l2 - l1) * (full - l1)
        rec["extrapolated"][key] = {"from": [l1, l2], "predicted_at_full": predicted,
                                    "at_full": at_full, "gap": (predicted - at_full) / at_full}
    rec["launches"] = launches
    rec["device"] = smi_line()
    emit(rec)
    return rec


KERNELS = {
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/flash_decode.py:134"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:99"),
    "ssd": ("src/repro_torch/kernels/csrc/ssd.cu", "src/repro/kernels/ssd.py:61"),
}


# the paged kernel's paths live in three sources (one C entry)
PATH_SOURCES = {"paged_attention": {
    "cuda_core": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "decode": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "tensor_core": "src/repro_torch/kernels/csrc/paged_tensor_core.cu",
    "tensor_core_mla": "src/repro_torch/kernels/csrc/paged_mla.cu"}}


def kernels_line(checks: dict, serve: dict, spec_serve: dict, ds_parity: dict, ds_serve: dict,
                 ds_store: dict, train: dict, evals: dict, ssm_serve: dict, ssm_eval: dict,
                 hybrid_static: dict, hybrid_serve: dict, hybrid_eval: dict,
                 zoo_serve: dict, moe_serve: dict, moe_eval: dict, mla_serve: dict,
                 slices: dict, trains: dict) -> dict:
    """One row per kernel: its launches on the main paths (serve,
    spec_serve, ds_parity's, ds_serve's and ds_store's payload runs, train,
    eval, ssm_serve, ssm_eval, the hybrid's static job through the control
    plane, hybrid_serve, hybrid_eval, each zoo model's serve run,
    moe_serve's dense and capacity runs, moe_eval's forwards, mla_serve's
    run, and ``slices``: danube_serve's, vlm_serve's and whisper_serve's
    runs, danube_eval's, vlm_eval's and whisper_eval's forwards; and
    ``trains``: family_train_parity's card runs, remat_train's, mesh's
    and roofline's counted steps: counts set to 0 before each run and read
    after), the paged kernel's and
    RMSNorm's also by kernel path, its worst error, and its times at its
    first timed shape with the others beside."""
    def total(runs):
        return {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}

    paths = {"serve": serve["launches"], "spec_serve": spec_serve["launches"],
             "ds_parity": ds_parity["launches"], "ds_serve": ds_serve["launches"],
             "ds_store": ds_store["launches"], "train": train["launches"], "eval": total(evals["runs"]),
             "ssm_serve": ssm_serve["launches"], "ssm_eval": total(ssm_eval["runs"]),
             "hybrid_static": hybrid_static["launches"],
             "hybrid_serve": hybrid_serve["launches"], "hybrid_eval": total(hybrid_eval["runs"]),
             **{f"zoo_serve_{arch}": r["launches"] for arch, r in zoo_serve.items()},
             "moe_serve": moe_serve["launches"],
             "moe_serve_capacity": moe_serve["capacity"]["launches"],
             "moe_eval": total(moe_eval["runs"]), "mla_serve": mla_serve["launches"],
             "danube_serve": slices["danube_serve"]["launches"],
             "danube_eval": total(slices["danube_eval"]["runs"]),
             "vlm_serve": slices["vlm_serve"]["launches"],
             "vlm_eval": total(slices["vlm_eval"]["runs"]),
             "whisper_serve": slices["whisper_serve"]["launches"],
             "whisper_eval": total(slices["whisper_eval"]["runs"]), **trains}
    timed_by_kernel = {
        "paged_attention": {**serve["kernel_times"]["paged_attention"],
                            **spec_serve["kernel_times"]["paged_attention"],
                            **{f"{arch}_{k}": t for arch, r in zoo_serve.items()
                               for k, t in r["kernel_times"]["paged_attention"].items()},
                            **{f"deepseek_{k}": t for k, t in
                               mla_serve["kernel_times"]["paged_attention"].items()},
                            **{f"internvl_{k}": t for k, t in
                               slices["vlm_serve"]["kernel_times"]["paged_attention"].items()},
                            **slices["whisper_serve"]["kernel_times"]["paged_attention"]},
        "rmsnorm": {**serve["kernel_times"]["rmsnorm"],
                    **{f"d2048_{k}": t for k, t in ssm_serve["kernel_times"]["rmsnorm"].items()},
                    **{f"d4096_{k}": t for k, t in hybrid_serve["kernel_times"]["rmsnorm"].items()},
                    **{f"d{t['shape']['d']}_{k}": t for r in zoo_serve.values()
                       for k, t in r["kernel_times"]["rmsnorm"].items()},
                    **{f"deepseek_{k}": t
                       for k, t in mla_serve["kernel_times"]["rmsnorm"].items()},
                    **{f"{arch}_d{t['shape']['d']}_{k}": t for arch, phase in
                       (("danube", "danube_serve"), ("internvl", "vlm_serve"))
                       for k, t in slices[phase]["kernel_times"]["rmsnorm"].items()}},
        "flash_attention": {**{f"{t['dtype']}_{t['shape']['BH']}x{t['shape']['S']}": t
                               for t in evals["kernel_times"]},
                            **{f"{t['dtype']}_{t['shape']['BH']}x{t['shape']['S']}_hd"
                               f"{t['shape']['hd']}": t
                               for t in hybrid_eval["kernel_times"]["flash_attention"]},
                            **{f"{t['dtype']}_{t['shape']['BH']}x{t['shape']['S']}_hd"
                               f"{t['shape']['hd']}_window{t['shape']['window']}": t
                               for t in [*moe_eval["kernel_times"],
                                         *slices["danube_eval"]["kernel_times"]]},
                            **{f"{t['dtype']}_{t['shape']['BH']}x{t['shape']['S']}_hd"
                               f"{t['shape']['hd']}": t
                               for t in slices["vlm_eval"]["kernel_times"]},
                            **{f"whisper_{t['dtype']}_{t['shape']['BH']}x{t['shape']['S']}"
                               f"{'x' + str(t['shape']['Skv']) if 'Skv' in t['shape'] else ''}"
                               f"_{'causal' if t['shape'].get('causal', True) else 'full'}": t
                               for t in slices["whisper_eval"]["kernel_times"]}},
        "ssd": {**{t["at"]: t for t in ssm_eval["kernel_times"]},
                **ssm_serve["kernel_times"]["ssd"],
                **{t["at"]: t for t in hybrid_eval["kernel_times"]["ssd"]},
                **hybrid_serve["kernel_times"]["ssd"]},
    }
    counters = launch_counters()
    kernel_paths = {name: {p: sum(counts[f"{name}_{p}"] for counts in paths.values())
                           for p in counters[name].launches_by_path}
                    for name in PATHED}
    rows = []
    for name, (source, replaces) in KERNELS.items():
        launches = {path: counts[name] for path, counts in paths.items()}
        timed = timed_by_kernel[name]
        first = next(iter(timed.values()))
        errs = [*checks["max_abs_err"][name].values(), *(t["max_abs_err"] for t in timed.values())]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            **({"path_sources": PATH_SOURCES[name]} if name in PATH_SOURCES else {}),
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": max(errs), "max_abs_err_by_dtype": checks["max_abs_err"][name],
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "at": next(iter(timed)),
            **({"launches_by_kernel_path": kernel_paths[name]} if name in PATHED else {}),
            **{f: first[f] for f in ("bound_route", "bound_ms_cuda_core", "launch_floor_ms")
               if f in first},
            "other_shapes": {k: {f: t[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "bound_route", "bound_ms_cuda_core",
                                                   "bound_ms_tensor_core", "library_ms",
                                                   "launch_floor_ms", "path", "cuda_core_ms",
                                                   "max_abs_err") if f in t}
                             for k, t in list(timed.items())[1:]},
        })
    return {"kernels": rows}


_LAP = [time.perf_counter()]


def lap(name: str) -> None:
    """One line with the seconds since the previous lap: what each phase
    costs of the script's time limit."""
    now = time.perf_counter()
    emit({"lap": name, "seconds": now - _LAP[-1]})
    _LAP.append(now)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)

    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    phase_env()
    # nvcc builds the kernels while the host draws the SSM and hybrid weights
    with ThreadPoolExecutor(max_workers=1) as pool:
        build = pool.submit(phase_build)
        cfg, params_cpu = ssm_weights()
        hcfg, hparams_cpu = hybrid_weights()
        build.result()
    lap("build, ssm_weights, hybrid_weights")
    checks = phase_kernels()
    lap("kernels")
    _, plain = phase_parity()
    lap("parity")
    serve = phase_serve()
    lap("serve")
    phase_profile()
    lap("profile")
    phase_spec_parity()
    lap("spec_parity")
    spec_serve = phase_spec_serve()
    lap("spec_serve")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ds_parity = phase_ds_parity(Path(tmp), plain)
        lap("ds_parity")
        ds_serve = phase_ds_serve(Path(tmp))
        lap("ds_serve")
        ds_store = phase_ds_store(Path(tmp), plain)
        lap("ds_store")
        del plain
    phase_train_parity()
    lap("train_parity")
    family_train = phase_family_train_parity((cfg, params_cpu), (hcfg, hparams_cpu))
    lap("family_train_parity")
    remat_train = phase_remat_train(cfg, params_cpu)
    lap("remat_train")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mesh = phase_mesh(Path(tmp))
    lap("mesh")
    roofline = phase_roofline()
    lap("roofline")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        train = phase_train(Path(tmp))
        lap("train")
        evals = phase_eval(Path(tmp))
        lap("eval")
        phase_ssm_parity(cfg, params_cpu)
        params = cast_params(params_cpu, torch.bfloat16, "cuda")
        del params_cpu
        lap("ssm_parity")
        ssm_serve = phase_ssm_serve(*first_layers(cfg, params, SSM_SERVE_LAYERS))
        lap("ssm_serve")
        ssm_eval = phase_ssm_eval(cfg, params, Path(tmp))
        del params
        release_device_memory()
        lap("ssm_eval")
        phase_hybrid_parity(hcfg, hparams_cpu)
        hparams = cast_params(hparams_cpu, torch.bfloat16, "cuda")
        del hparams_cpu
        lap("hybrid_parity")
        hybrid_serve = phase_hybrid_serve(*first_layers(hcfg, hparams, HYBRID_SERVE_LAYERS))
        lap("hybrid_serve")
        save_s = save_hybrid_checkpoint(hparams, Path(tmp))
        hybrid_static = phase_hybrid_static(hcfg, hparams, Path(tmp))
        del hparams
        release_device_memory()
        lap("hybrid_static")
        hybrid_eval = phase_hybrid_eval(hcfg, Path(tmp), save_s)
        lap("hybrid_eval")
    phase_zoo_parity()
    lap("zoo_parity")
    zoo_serve = phase_zoo_serve()
    lap("zoo_serve")
    _, moe_params = phase_moe_parity()
    lap("moe_parity")
    phase_moe_window(moe_params)
    del moe_params
    release_device_memory()
    lap("moe_window")
    moe_serve = phase_moe_serve()
    lap("moe_serve")
    moe_eval = phase_moe_eval()
    lap("moe_eval")
    phase_mla_parity()
    lap("mla_parity")
    mla_serve = phase_mla_serve()
    lap("mla_serve")
    slices = {}
    for name, phase in (("danube_parity", phase_danube_parity),
                        ("danube_serve", phase_danube_serve),
                        ("danube_eval", phase_danube_eval), ("vlm_parity", phase_vlm_parity),
                        ("vlm_serve", phase_vlm_serve), ("vlm_eval", phase_vlm_eval),
                        ("whisper_parity", phase_whisper_parity),
                        ("whisper_serve", phase_whisper_serve),
                        ("whisper_eval", phase_whisper_eval)):
        slices[name] = phase()
        lap(name)
    emit(kernels_line(checks, serve, spec_serve, ds_parity, ds_serve, ds_store, train, evals,
                      ssm_serve, ssm_eval, hybrid_static, hybrid_serve, hybrid_eval, zoo_serve,
                      moe_serve, moe_eval, mla_serve, slices,
                      {"family_train_parity": family_train["launches"],
                       "remat_train": remat_train["launches"],
                       "mesh_train": mesh["launches"]["train"],
                       "mesh_eval": mesh["launches"]["eval"],
                       "roofline": roofline["launches"]}))
    name = torch.cuda.get_device_name(0)
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
