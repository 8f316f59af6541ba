"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:

1. device: a CUDA device must be present; prints its name and power limit;
   TF32 off for matmuls and convolutions (full fp32).
2. build: compiles every CUDA kernel of the serve and train paths from
   ``src/repro_torch/kernels/csrc`` with nvcc, all at once (four); prints
   each kernel's registers and counts the tensor-core instructions (HMMA)
   of flash attention's tensor-core instances in the built library's SASS
   (``cuobjdump -sass``, where the toolkit has it): each must have some and
   none may spill; nor may WKV6's instances, whose shared bytes at D = Dv =
   64 and the blocks an SM they allow are printed.
3. parity: each kernel against its plain PyTorch version on the same CUDA
   tensors, f32 and bf16, at the serve paths' shapes and the edge cases
   (q_offset, window, softcap, non-causal, D != Dv, ragged lengths, flash
   attention's D = 128 instance at group 16 and with window and softcap,
   decode rows with kv_len past the slots and at 0, the edges of the
   decode kernels' splits, gemma2-27b's windowed and global prefills at
   4,608 tokens and its ring decode after the ring wraps (K3 over the
   ring's valid slots against the plain ring decode), minicpm3-4b's D = 96,
   Dv = 64 prefill on 40 heads; for paged attention both entry
   points, windows T = 1..5, a null-block free slot, permuted tables, a
   poisoned table tail and limits on page and split boundaries; for WKV6
   ragged T, T < chunk, chunk 16, strong decay down to w = 1e-6 with finite
   outputs, a given initial state, out and final state both, and Dv 6 and 2,
   where the value columns do not split evenly over the kernel's 4-block
   cluster and some blocks own none; whisper-medium's non-causal encoder
   and cross-attention prefills (Sq != Skv) and its cross decode over
   1,536 rows; llama4-maverick's group 5, 40 over 8 heads at D = 128, at its
   serve and long shapes for all three attention kernels; chatglm2-6b's
   4 x 512 batch of phase 16 on the card alone and its shards under phase
   16's plans: a tp_dp rank's 2 x 512 prefill on 16 over 1 heads and its
   decode at kv 516 of 528, longctx_seqshard ranks' 128 query rows over 512
   keys at q_offsets 384 and 0; phase 17's forwards); then flash
   attention's gradient on the card (the kernel's forward and its torch-ops
   backward through the ``autograd.Function``) against autograd of the plain
   version, dq, dk and dv, f32 and bf16, at smollm-135m's training shape,
   chatglm2-6b's D = 128 at group 16, gemma2-27b's window of 4,096 with
   softcap 50, minicpm3-4b's D = 96 / Dv = 64, whisper's non-causal cross
   attention (Sq != Skv), a q_offset > 0, and phase 17's shapes (4 x 512
   a step: chatglm2-6b on the card alone and on a tp_dp or tp_dp_fsdp
   rank, qwen2-moe-a2.7b on the card alone and on an ep_tp_fsdp rank);
   WKV6 also at phase 19's rank shapes (2 rows over 20 heads of 64, one
   row a prompt length the ranks' prefills take); K2, its gradient and K3
   at phase 20's rank shapes (2 rows over 8 heads of 64: the encoder over
   1,536 frames, the decoder's self and cross prefills and steps, the
   train step's forwards), and K3 at phase 16's serve batches on a rank.
4. times: each kernel, its plain version and the one PyTorch call that
   computes the same function where there is one (scaled_dot_product_attention,
   timed only as a yardstick; none reads K/V through a block table, none
   computes WKV6 or a tanh softcap); the profiler must see one device activity per kernel
   call; every kernel also with a cold L2 (64 MB written between launches,
   only the kernel's own activities summed).  A bound prices fp32
   operations at the TF32 tensor cores' rate over three (3xTF32, the
   card's fastest route to fp32-accurate products).  llama4-maverick's
   shapes are timed in bf16, its main path's dtype, and bounded at the
   bf16 tensor cores' rate.  At smollm-135m's training shape, flash
   attention's forward and backward together (the kernel and its torch-ops
   gradient) beside the plain version's autograd and SDPA's forward and
   backward, against the bound of 2 (4D + 3Dv) operations a visible pair;
   and the gradient alone against 2 (3D + 2Dv) a pair (it recomputes the
   scores).
5. serve: the default serve path of ``repro_torch.launch.serve`` at full
   width (smollm-135m, 30 layers, d_model 576), then one longer padded batch
   (4 x 1024-token prompts, 32 new tokens); checks that both kernels ran on
   every prefill and decode step, and that the first batch's logits on the
   card match the same engine on the CPU.
6. paged serve: ``serve --paged`` at full width in four flag sets (plain;
   prefix cache on the shared-prefix workload with 16-token chunks;
   speculation with 4 n-gram drafts; preemption at a 3e6-byte pool), then
   one long paged batch (4 x 1024-token prompts, 32 new tokens, 16-token
   pages); checks that paged attention ran once per layer on every decode or
   verify step and flash attention once per layer on every prefill chunk,
   that every run passed the engine's leak audit, and that the paged
   engine's first prefill and decode logits on the card match the CPU.
7. rwkv serve: rwkv6-3b at full width (32 layers, d_model 2560, 40 heads
   of 64), its weights drawn once and served through ``serve.serve``
   padded and ``--continuous``, then one long padded batch (4 x 1024-token
   prompts, 32 new tokens); checks that
   WKV6 ran once per layer on every prefill (and no attention kernel ran),
   profiles one decode step and the long prefill, and checks the first
   batch's logits on the card against the CPU at full width and the first
   4 of the 32 layers.
8. dense serve: ``serve --arch qwen2-1.5b`` at full width (28 layers,
   d_model 1536, 12 heads over 2 KV heads of 128, vocab 151,936) on the
   padded path; then chatglm2-6b, the paper's own model, at full width
   (d_model 4096, 32 heads over 2 KV heads of 128) and 14 of its 28
   layers, its weights drawn once and served through ``serve.serve``
   padded, ``--continuous`` and ``--paged`` (a 2e7-byte pool); then the
   live cluster (``[cluster]`` lines), ``serve --replicas 2 --paged`` on
   the same weights through ``serve.serve_cluster``: two paged replicas,
   each with its own 2e7-byte pool, routed (a) least_loaded and (b)
   slo_aware on the 12 seeded alpaca requests and (c) prefix_affinity with
   the prefix cache and 16-token chunks on the shared-prefix mix (beside
   one single paged run of that mix), each replica's share, prefill tokens,
   prefix hits and peak pages, the router's stats, tokens a second and the
   requests whose outputs equal the single paged engine's; then one long
   padded batch (4 x 1024-token prompts, 32 new tokens).  Checks that flash
   attention ran once per layer on every prefill (chunk), decode attention
   once per layer on every padded decode step and paged attention on every
   paged step, summed over the replicas (and WKV6 never), that the router
   dispatched or shed all 12, that every replica passed the engine's leak
   audit and that (c) hit the prefix cache; profiles the long prefill and
   a decode step, and checks the first batch's logits on the card against
   the CPU at full width and the first 2 layers, for both models.
   Observability (``[obs]`` lines): chatglm2-6b's ``--paged`` run and the
   live cluster's run (a) each carry a ``Tracer`` and a ``CostProfiler``
   (run (a)'s priced against the replicas' ``LatencyModel`` on the paper's
   cluster); each writes its Chrome trace and metrics JSON under
   ``chiprun_out/obs/``, which must validate and pass ``check_invariants``,
   and the distinct decode iterations and the ``prefill_chunk`` spans of
   its trace, times 14 layers, must equal the paged and flash attention
   launches of that run.  The ``--paged`` run is then made six times
   untraced and six times traced (a cost profiler with a reference model)
   in alternating order, for the tracing overhead as the reference's gate
   measures it (the outputs must not change).  Run (a)'s profile is saved, each of
   its decode and prefill cells printed beside the ``LatencyModel``'s
   mean at the same operating points, and (a) is run again with that
   registry as ``--profile-in`` and ``--pricing-quantile 0.95``: its
   calibration and drift lines are printed, and pricing must have covered
   some projections.  Then ``ci.sh``'s profile round trip, ``serve --paged
   --speculate --chunk-tokens 8 --requests 8`` (the reduced smollm-135m)
   with ``--profile-out`` and then ``--profile-in``: both outputs digests
   must equal the same argv's on the CPU.
9. window and MLA serve (``[window]`` and ``[mla]`` lines): gemma2-27b at
   full width (d_model 4608, 32 heads over 16 KV heads of 128, d_ff 36,864,
   vocab 256,000, local layers with a 4,096-token window and softcap 50),
   its depth cut from 46 to 6 layers (3 local/global pairs; ``serve.main``
   would keep 24 on an 80 GB card, ``serve.fit_depth``, which is checked
   on the host), drawn once on the card from a seeded CUDA generator
   and served through ``serve.serve``
   padded and ``--continuous`` (cache_len 64: every local layer keeps a
   ring of 64), then one long padded batch of prompts of 4,608 and 4,300
   tokens (32 new, cache_len 4,640: the local layers keep a ring of 4,096
   that wraps); then minicpm3-4b (Multi-head Latent Attention, d_model
   2560, 40 heads, D = 96, Dv = 64) at full width and 31 of its 62 layers,
   padded and ``--continuous``, and a 4 x 1024 padded batch.  Checks that flash
   attention ran once per layer on every prefill, decode attention once per
   layer on every gemma2-27b decode step (its local layers through the
   ring) and never on minicpm3-4b (latent-space decode with torch ops),
   that the long batch's local caches are rings of 4,096, profiles both
   long prefills and a decode step of each, and checks card-vs-CPU logits
   at full width and 2 layers of each (gemma2-27b: one local, one global).
10. MoE and M-RoPE serve (``[moe]`` and ``[vlm]`` lines): qwen2-moe-a2.7b at
   full width (d_model 2048, 16 heads over 16 KV heads of 128, 60 routed
   experts top-4 and 4 shared ones of 1,408 units, vocab 151,936) and 6 of
   its 24 layers (``serve.fit_depth`` would keep all 24, 57.25 GB of f32
   weights, which is checked on the host), then qwen2-vl-7b at full width
   (d_model 3584, 28 heads over 4 KV heads of 128, M-RoPE) and 14 of its
   28 layers (all 28, 30.46 GB, would fit), each drawn once on the card
   from a seeded CUDA generator and served through
   ``serve.serve`` padded, ``--continuous`` and
   ``--paged`` (a 1.1e8-byte pool: 34 pages of 8 tokens for qwen2-moe),
   then one long padded batch (4 x 1024-token prompts, 32 new tokens).
   Checks the launches as phase 8 does, prints the largest fraction of
   (token, expert) entries the MoE capacity dropped at a prefill, the
   expert GEMMs' device time at the long prefill's and a decode step's
   shapes, and the bytes of weights a decode step reads against its
   device time, profiles both long prefills and a decode step of each, and
   checks card-vs-CPU logits at full width and 2 layers of each, with the
   smallest router top-k margin of qwen2-moe's inputs beside them.
11. encoder-decoder (``[encdec]`` lines): whisper-medium at full width and
   depth (24 encoder + 24 decoder layers, d_model 1024, 16 over 16 heads of
   64, d_ff 4096, vocab 51,865; 3.0 GB of f32 weights, kept whole by
   ``serve.fit_depth``), drawn once and driven through the model API on
   seeded frames [4, 1,536, 1024] x 0.02, as the reference's tests drive it
   (its serve engine passes no frames): a short batch (4-token decoder
   prompts, 16 greedy new tokens, cache_len 20) and a long right-padded
   batch (prompts of 448, 300, 64 and 4 tokens, 32 new, cache_len 480).
   Checks that flash attention ran exactly 3 x 24 times a prefill (the
   non-causal encoder over 1,536 frames, the causal decoder, the
   non-causal cross-attention) and decode attention 2 x 24 times a step
   (self, and cross over all 1,536 memory rows), no other kernel, finite
   logits and the cache's shapes; prints prefill ms, decode ms a step,
   tok/s and a digest of each batch, profiles the long prefill and a long
   decode step, and checks card-vs-CPU logits at 2 encoder + 2 decoder
   layers.
12. llama4-maverick (``[llama4]`` lines, and ``[moe]`` lines of its MoE
   layer): ``serve.fit_depth`` must raise in f32 (one group period, a dense
   layer and a layer of 128 experts, with the embeddings: 74.2 GB) and keep
   that one period, 2 layers, in bf16 (37.1 GB), the reference's
   deployment dtype; the period at full width (d_model 5120, 40 heads over
   8 KV heads of 128, d_ff 8192, 128 routed experts of 8192 top-1 and a
   shared one, vocab 202,048) drawn once in bf16 on the card from a seeded
   CUDA generator (its seconds and the process's peak host memory
   printed) and served through ``serve.serve`` padded, ``--continuous`` and ``--paged`` (bf16 pools of
   64 KiB pages, 4e6 bytes), then a 4 x 1024 padded batch with
   ``[profile]`` lines; the largest prefill drop fraction, the expert
   GEMMs' device time at T = 4,096 and T = 4, a decode step's 35.0 GB of
   weights against its device time; the HELR plan at ``decode_32k``; K2
   exactly 2 a prefill, K3 2 a padded step, K1 2 a paged step, K4 never;
   then card-vs-CPU logits at full width and both layers, the CPU running
   on the card's own weights moved back, within 3e-2 of the largest logit
   (bf16), the argmax equal wherever the top two logits are further apart
   than that, the router margin beside.
13. jamba (``[jamba]`` lines, and ``[moe] jamba:`` ones): ``serve.fit_depth``
   must raise in f32 and in bf16 (one group period of 8 layers with the
   embeddings is 90.2 GB in bf16), and so must ``serve --no-reduced`` and
   ``serve --paged`` (the Mamba state is recurrent, not a KV cache, as the
   reference says); the first five layers (Mamba with a dense MLP, Mamba
   with 16 experts top-2, twice, then the attention layer; 23.98 G
   parameters, 47.96 GB in bf16) at full width (d_model 8192, 64 heads over
   8 KV heads of 128 with no positions, Mamba d_inner 16,384, d_state 16,
   d_ff 24,576, experts of 24,576, vocab 65,536) drawn once in bf16 on the
   card from a seeded CUDA generator and
   served through ``serve.serve`` padded and ``--continuous``, then a 4 x
   1024 padded batch with ``[profile]`` lines; one Mamba layer's prefill
   and its scan at T = 4,096 against the scan's bytes; the largest prefill
   drop fraction, the expert GEMMs, a decode step's bytes against its
   device time; the HELR plan at ``decode_32k``; K2 exactly 1 a prefill,
   K3 1 a step (only layer 4 attends), K1 and K4 never; card-vs-CPU logits
   at all five layers on the card's weights moved back, within 3e-2 of the
   largest logit, the argmax equal wherever the top two are further apart.
   jamba's group-8 shapes of K2 and K3 (64 over 8 heads, D = 128) are
   timed in bf16, as llama4's are.
14. simulated cluster (``[cluster] sim`` lines): ``serve.main`` with
   ``--arch chatglm2-6b --replicas 4`` on the discrete-event simulator,
   the length predictor on the card and no weights drawn: each of the four
   routers, ``--autoscale --workload bursty``, a two-model fleet
   (``--models chatglm2-6b:0.6,qwen2-1.5b:0.4 --autoscale``) under
   ``--fleet joint`` and ``independent``, and a scripted crash with random
   crashes and brownout (``--fault-crash 2.5:1 --fault-mtbf 20
   --fault-mttr 2 --brownout-tiers batch``); prints each ``cluster:``
   summary and checks finished + shed = offered, that the monitor observed
   every offered request, and that no kernel launched; the slo_aware run
   also writes its trace, metrics JSON and profile under
   ``chiprun_out/obs/``, each validated, and runs again with that profile
   as ``--profile-in`` at ``--pricing-quantile 0.95``: the CLI's profiles
   carry no measured / model ratios, so its pricing covers nothing
   (printed beside phase 8's) and its summary must equal the uncalibrated
   run's.
15. train (``[train]`` lines): smollm-135m at full width and depth (30
   layers, d_model 576, 9 over 3 heads of 64, vocab 49,152, tied
   embeddings) trains through ``launch.train.main --no-reduced --batch 4
   --seq 1024`` with AdamW for 30 steps, checkpointing at step 20 (under
   ``build/``: 1.6 GB); checks that flash attention launched 30 x steps
   times and its gradient ran as many times (no other kernel), that the
   loss fell; restores the checkpoint into fresh tensors on the card and
   reruns steps 20-29, whose losses must equal the first run's within 1e-4
   relative (the embedding's backward sums with atomics); prints the step
   time and tokens a second, profiles one step (device busy, idle share,
   top device ops), holds one loss and gradient of the phase's own weights
   cut to 2 layers at 4 x 256 tokens against the CPU (loss within 1e-4
   relative, each gradient within 1e-3 of its leaf's largest magnitude),
   and runs Adafactor for 5 steps (launches exact, the loss falls).
16. sharded serve (``[sharded]`` lines): multi-device serving as 4 ranks
   of ``torch.distributed`` that share the one card (gloo: NCCL takes one
   rank a GPU; every collective goes through host memory), spawned after
   the kernels are built.  chatglm2-6b at full width and 7 layers (f32)
   and qwen2-moe-a2.7b at full width and 2 layers (capacity factor 8: no
   drops, so the batch-sharded MoE is the unsharded function) are first
   served on the card alone, then by the ranks through
   ``InferenceEngine(plan=)``: chatglm2-6b under tp_dp on {data: 2,
   model: 2} (batch over data, head-TP: 16 over 1 heads a rank) and
   longctx_seqshard on {data: 1, model: 4} (the sequence-parallel prefill,
   128 query rows a rank of a 512-token prompt; the cache
   sequence-sharded, decoded by partial softmax and merge), qwen2-moe
   under ep_tp (30 of its 60 experts a rank, the all-to-all on CUDA
   tensors).  Each on the 12 serve requests in batches of 4, chatglm2-6b
   also on a 4 x 512 batch (8 new tokens); each rank draws the full
   weights in turn from the seeded CUDA generator (one full copy on the
   card at a time) and keeps its slices.  Checks that every run's tokens
   equal the card's alone, the first batch's prefill and decode logits
   within 1e-3, and K2 and K3 launched on every rank exactly layers x
   prefills and layers x decode steps (K3 none where the cache is
   sequence-sharded), on rank 0 also as device activities of one batch
   under torch.profiler; prints each batch's prefill and decode times
   beside the card's alone.
17. sharded training (``[sharded_train]`` lines): ``make_train_step(cfg,
   plan, tcfg)`` on 4 ranks sharing the card over gloo, as in phase 16,
   on {data: 2, model: 2}.  chatglm2-6b at full width and 4 layers (f32,
   4 x 512 tokens a step, the train launcher's rolled tokens) for 2 AdamW
   steps under tp_dp (seq_parallel, remat, micro-batches 2) and under
   tp_dp_fsdp (the weights cut over data too, gathered a block at a time);
   qwen2-moe-a2.7b at full width and 2 layers (capacity factor 8) for 2
   Adafactor steps under ep_tp_fsdp.  Rank 0 first trains each model on
   the card alone from the same weights (the MoE's loss and gradient the
   mean over the two batch shards, whose capacity and lb_loss the sharded
   block computes per shard).  Checks every rank's loss and grad norm at
   every step within 1e-4 relative of the card alone's, step 1's
   gradients, gathered, within 1e-3 of each leaf's largest, and flash
   attention's forward on each rank exactly layers x micro-batches x
   steps x 2 (remat runs it again in the backward) and its gradient
   layers x micro-batches x steps, no other kernel, and every shape at
   which a rank called K2 a parity case of phase 3 (those under grad a
   gradient case); prints each step's time beside the card alone's, rank
   0's bytes of parameters and optimizer state, its peak memory and its
   seconds in gloo.  Step 1's gradients come from a pass of their own
   before the counted steps.
18. sharded paged serve (``[sharded_paged]`` lines): ``PagedEngine(plan=
   dp)`` on 4 ranks sharing the card over gloo on {data: 2, model: 2}
   (batch over both axes: one of the 4 slots a rank; every rank holds a
   whole replica and the whole pools).  chatglm2-6b at full width and 14
   layers (f32, drawn on the card from the seeded CUDA generator, 16-token
   pages, a 48-page pool) serves on the card alone, which is then freed,
   and on the ranks: the 12 serve requests; the shared-prefix mix (8
   requests) with the prefix cache and 16-token chunks, then a second wave
   of 8 that extends the first's answers, in the first order whose run on
   the card alone hits, on another slot, blocks a first-wave sequence
   decoded; the 12 serve requests with 4 n-gram drafts.  Checks every
   rank's tokens and admissions equal to the card alone's, its pools
   within 1e-5 of the card alone's largest value, K1 layers x steps and
   K2 layers x prefill chunks on every rank, gloo calls layers + 1 a step,
   that second-wave hit, and every K1 and K2 shape a rank called a parity
   case; prints the decode step's wall time beside the card alone's and
   rank 0's calls and seconds in gloo.
19. sharded recurrent serve (``[sharded_recurrent]`` lines): Mamba and
   RWKV-6 blocks under tp_dp on {data: 2, model: 2} (batch over data, the
   blocks over model), 4 ranks sharing the card over gloo, against the
   card alone.  rwkv6-3b at full width and 8 of its 32 layers (f32, 3.9
   GB; the time mix head-parallel: K4 on each rank's 2 rows of a batch of
   4 over 20 of the 40 heads, ``o`` and the channel mix row-parallel) and
   jamba-1.5-large-398b at full width and its first layer (f32, 8.3 GB:
   the Mamba mixer, d_inner 16,384, channel-parallel, its in_proj's x
   columns on model-rank 0 and z columns on model-rank 1, and a dense MLP
   of 24,576), each drawn on the card from the seeded CUDA generator,
   served on the card alone, which is then freed, and by the ranks, each
   drawing the full weights in turn and keeping its slices: the 12 serve
   requests in batches of 4, padded, then through the continuous engine
   (4 slots).  Checks every rank's tokens (both modes) and admissions
   (each prefill's row lengths) equal to the card alone's, the first
   batch's prefill and decode logits within 1e-3, K4 on every rank layers
   x prefills (none for jamba, and no attention kernel), every K4 call at
   20 heads and every K4 shape a rank called a parity case, and the gloo
   calls of one decode step (3 + 3 an RWKV-6 layer, 3 + 5 for jamba's
   layer); prints the decode step's wall time beside the card alone's,
   rank 0's calls and seconds in gloo, and each rank's memory after its
   slices were cut and its peak while serving.
20. sharded encoder-decoder (``[sharded_encdec]`` lines): whisper-medium
   under a plan on {data: 2, model: 2}, 4 ranks sharing the card over gloo,
   against the card alone, each run drawing the weights from the seeded
   CUDA generator (the ranks in turn).  Served at full width and depth
   (24 + 24 layers, f32, 3.03 GB: 1.41 GiB of slices a rank) under tp_dp
   (batch over data; the encoder, self- and cross-attention head-parallel
   at 8 of the 16 heads, the MLP Megatron's, the embedding and head
   vocab-parallel) through the model API on phase 11's frames, short
   batch and long batch; then trained at full width and 2 + 2 layers
   under tp_dp_train (sequence-parallel residual; the encoder-decoder runs
   no remat, as the reference's) for 2 AdamW steps of 4 x 64 tokens over
   4 x 1,536 frames.  Checks every rank's greedy tokens equal to the card
   alone's, the short batch's prefill and first decode-step logits within
   1e-3, on every rank K2 72 times a prefill and K3 48 times a step (as on
   the card alone), every call at 8 heads and every shape a parity case,
   the caches' shapes a rank and 75 gloo calls a decode step; every rank's
   losses and grad norms within 1e-4 of the card alone's, step 1's
   gradients, slice by slice, within 1e-3 of each leaf's largest plus
   1e-8 (the key biases' true gradient is 0), K2's forward and gradient 12
   times a step; prints the prefill and decode step times beside the card
   alone's, the gloo calls a step, each rank's memory held and peak, the
   train steps' times and rank 0's seconds in gloo.
21. dry run (``[dryrun]`` lines): ``launch.dryrun`` (rank r's program on
   meta tensors over a fake process group: nothing launches on the card)
   in a subprocess of this script, its cells' ranks over 8 worker
   processes.  (a) production cells at full width on the 16x16 fake mesh,
   priced at the H100: the hillclimb's three climbs (``launch.hillclimb``)
   and train_4k and decode_32k of smollm-135m, gemma2-27b, minicpm3-4b,
   qwen2-moe-a2.7b, llama4-maverick-400b-a17b, jamba-1.5-large-398b,
   rwkv6-3b and whisper-medium (not rwkv6-3b's train cell, which the dry
   run skips, nor jamba's, ~10 minutes a rank of one core: DRYRUN_CELLS);
   each cell's plan, whether its peak fits 80 GiB, GiB a rank of
   parameters, optimizer state, cache and peak, collective calls and bytes
   by kind and the kernel calls.  (b) phases 17, 19 and 20's configs,
   batches, plans and f32 on 4 fake ranks, held exactly to what those
   phases measured on the card: each rank's parameter-slice bytes and
   phases 17 and 20's optimizer-state bytes, the collective calls of a
   decode step (27 and 8 for rwkv6-3b and jamba, 75 for whisper-medium),
   K2 and K3 calls a step (72 a prefill and 48 a step for whisper-medium);
   the dry run's peak is printed beside each rank's measured peak, with
   their ratio (no bound).  Any error fails the phase.
Card-vs-CPU logits at a cut depth run on the phase's own weights: their
first layers, moved to the CPU after the card's run.  Each path runs with
the launch counts set to 0 just before it and read just after.  A
``[phase]`` line gives each phase's seconds; a ``[train] grad`` line
gives flash attention's gradient's numbers (backward calls, error, times
beside the plain version's and SDPA's, bounds).  The last three
lines are a JSON object of per-kernel numbers (launches on those paths,
error, device time, plain-version and library times, bound), the card's name and power limit as nvidia-smi reports them,
and ``{"ok": true, "device": {...}}``.  A copy of every number goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import resource
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from dataclasses import asdict, replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import (H100, SHAPES, get_config,  # noqa: E402
                                 group_period)
from repro_torch.core import helr_mesh  # noqa: E402
from repro_torch.core.types import Batch, Request  # noqa: E402
from repro_torch.distributed.ranks import run_ranks  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_reference)
from repro_torch.kernels.decode_attention.ops import decode_splits  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_grad, flash_attention_reference)
from repro_torch.kernels.flash_attention.ref import attention_mask  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_reference,
    paged_window_attention, paged_window_attention_reference)
from repro_torch.kernels.paged_attention.ops import paged_splits  # noqa: E402
from repro_torch.kernels.wkv6 import (  # noqa: E402
    wkv6, wkv6_chunked, wkv6_sequential)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, hillclimb, serve, train  # noqa: E402
from repro_torch.perf.cost_model import ParallelismDesc  # noqa: E402
from repro_torch.models import api, attention, mamba, moe  # noqa: E402
from repro_torch.models import rwkv as rwkv_model  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    ring_decode, ring_decode_attention, ring_lengths)
from repro_torch.params import shard_params, stacked_leaves  # noqa: E402
from repro_torch.obs import (CostProfiler, Tracer,  # noqa: E402
                             check_invariants, validate_metrics,
                             validate_trace)
from repro_torch.serving import (EngineConfig, InferenceEngine,  # noqa: E402
                                 PagedEngine, PagedEngineConfig, Replica,
                                 greedy, paper_cluster)
from repro_torch.serving import paged_engine  # noqa: E402
from repro_torch.sharding import Mesh, ShardingPlan, set_mesh  # noqa: E402
from repro_torch.sharding.specs import (gather_tensor,  # noqa: E402
                                        shard_tensor)
from repro_torch.training import (OptConfig, TrainConfig,  # noqa: E402
                                  init_opt_state, init_training,
                                  load_train_state, make_train_step,
                                  train_state_tree)
from repro_torch.training import trainer  # noqa: E402

# Bounds use the H100 data sheet's peaks: HBM bytes/s, and FLOP/s of bf16
# and of fp32 at fp32 accuracy, the fastest route to which is the TF32
# tensor cores with each operand split in two (3xTF32: 495 / 3 TFLOP/s,
# above the 67 of fp32 FMA).
PEAK_FLOPS = {torch.float32: H100.peak_flops_tf32 / 3,
              torch.bfloat16: H100.peak_flops}
TOL_F32 = 1e-4            # fp32 kernel vs fp32 plain: summation order only
TOL_BF16 = 2e-2           # x max|ref|: both round the output to bf16
TOL_LOGITS = 1e-3         # card vs CPU logits, f32, 30 layers
# card vs CPU logits in bf16, x max|logits|: both round every product and
# the residual adds to bf16, in different orders (the reference's own bf16
# kernel tests allow 3e-2)
TOL_BF16_LOGITS = 3e-2
SERVE_ARGS = ["--no-reduced", "--device", "cuda"]
LONG_PROMPT, LONG_NEW, LONG_CACHE = 1024, 32, 1088
# gemma2-27b's long batch: two prompts past its 4,096-token window, a cache
# wide enough for 32 new tokens (its local layers keep a ring of 4,096)
GEMMA2_WINDOW = 4096
GEMMA2_LONG, GEMMA2_CACHE = (4608, 4300), 4640
# the depths phases 8-10 run at full width, in whole group periods, so
# that the script, jamba's phase 13 included, stays within 900 s: the
# host's draws of their f32 weights take most of those phases' time.  3 of
# gemma2-27b's local/global pairs (fit_depth keeps 24 of 46 layers on an
# 80 GB card), 6 of qwen2-moe-a2.7b's 24 MoE layers and 14 of qwen2-vl-7b's
# 28 (fit_depth keeps all of either), 31 of minicpm3-4b's 62, 14 of
# chatglm2-6b's 28
GEMMA2_LAYERS, QWEN2_MOE_LAYERS, QWEN2_VL_LAYERS = 6, 6, 14
MINICPM3_LAYERS, CHATGLM2_LAYERS = 31, 14
LLAMA4 = "llama4-maverick-400b-a17b"
# phase 13: jamba's first five layers (Mamba/dense, Mamba/MoE, Mamba/dense,
# Mamba/MoE, attention/dense) at full width in bf16: one group period of
# 8 layers is 90.2 GB in bf16
JAMBA, JAMBA_LAYERS = "jamba-1.5-large-398b", 5
JAMBA_PLAN = [("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
              ("mamba", "moe"), ("attn", "dense")]
# phase 12's paged pool: a bf16 page of 8 tokens is 8 x 2 layers x (K, V)
# x 8 KV heads x 128 x 2 B = 64 KiB; 4e6 B buy 61, 4 slots of 8 and more
LLAMA4_BUDGET = "4e6"
# whisper-medium: 1,536 memory frames; a short batch of 4-token decoder
# prompts (the start-of-transcript prefix) with 16 new tokens, and a long
# batch of right-padded prompts up to the decoder's 448-token context with
# 32 new
WHISPER_FRAMES = 1536
WHISPER_SHORT, WHISPER_SHORT_NEW, WHISPER_SHORT_CACHE = 4, 16, 20
WHISPER_LONG, WHISPER_LONG_NEW, WHISPER_LONG_CACHE = (448, 300, 64, 4), 32, 480
WHISPER_PARITY_LAYERS = 2      # card vs CPU: 2 encoder + 2 decoder layers
WHISPER_BATCHES = (  # what, prompt lengths, new tokens, cache_len
    ("short batch", [WHISPER_SHORT] * 4, WHISPER_SHORT_NEW, WHISPER_SHORT_CACHE),
    ("long batch", list(WHISPER_LONG), WHISPER_LONG_NEW, WHISPER_LONG_CACHE))
N_TIMED = 25
PAD_SPINS, SPIN = 128, "spin_kernel"   # see device_kernels
# profiled windows, the most spin kernels one of them lost, and the windows
# that lost every spin (and were retried)
PROFILER = {"windows": 0, "max_lost": 0, "all_lost": 0}

# phase 15: smollm-135m trains at full width and depth, 4 x 1024 tokens a
# step, through the train CLI
TRAIN_ARGS = ["--no-reduced", "--device", "cuda", "--batch", "4", "--seq",
              "1024"]
TRAIN_STEPS, ADAFACTOR_STEPS, TRAIN_TOKENS = 30, 5, 4 * 1024
# the checkpoint (1.6 GB of f32 weights and AdamW moments) stays out of
# chiprun_out/, which brings back at most 64 MiB
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
# a rerun's losses against the first run's, relative: the embedding's
# backward sums the rows of repeated tokens with atomics, in any order
TOL_RESUME = 1e-4
TOL_TRAIN_LOSS = 1e-4       # card vs CPU loss, relative (f32)
TOL_TRAIN_GRAD = 1e-3       # card vs CPU gradient, x the leaf's largest |g|
TRAIN_PARITY_LAYERS, TRAIN_PARITY_SEQ = 2, 256
# K2's gradient vs autograd of the plain version, x the largest |grad|
TOL_GRAD_F32 = 1e-4
GRAD_PARITY_TAG = "flash_attention_grad/smollm_train/float32"
GRAD_CASES = [  # name, b, sq, skv, h, kv, d, dv, causal, window, softcap, q_offset
    ("smollm_train", 4, 1024, 1024, 9, 3, 64, 64, True, None, None, 0),
    ("chatglm2_d128_group16", 2, 1024, 1024, 32, 2, 128, 128, True, None,
     None, 0),
    ("gemma2_window_softcap", 1, 4608, 4608, 32, 16, 128, 128, True, 4096,
     50.0, 0),
    ("minicpm3_d96_dv64", 4, 1024, 1024, 40, 40, 96, 64, True, None, None, 0),
    ("whisper_cross", 4, 448, 1536, 16, 16, 64, 64, False, None, None, 0),
    ("chunk_q_offset", 4, 16, 32, 9, 3, 64, 64, True, None, None, 16),
    # phase 17's K2 calls under grad (4 x 512 tokens a step, D = 128,
    # causal): chatglm2-6b on the card alone (2 rows a micro-batch, 32 over
    # 2 heads) and on a rank (16 over 1 heads: 1 row a micro-batch under
    # tp_dp, 2 under tp_dp_fsdp); qwen2-moe-a2.7b on the card alone (2 rows
    # a batch shard, 16 over 16) and on an ep_tp_fsdp rank (2 rows, 8 over 8)
    *((name, b, 512, 512, h, kv, 128, 128, True, None, None, 0)
      for name, b, h, kv in (("chatglm2_train_alone", 2, 32, 2),
                             ("chatglm2_train_tp2_micro", 1, 16, 1),
                             ("chatglm2_train_tp2", 2, 16, 1),
                             ("qwen2_moe_train_alone", 2, 16, 16),
                             ("qwen2_moe_train_tp2", 2, 8, 8))),
    # phase 20's K2 calls under grad (4 x 64 tokens over 4 x 1,536 frames,
    # heads of 64) on the card alone (4 rows, 16 over 16 heads) and on a
    # tp_dp_train rank (2 rows, 8 over 8): the non-causal encoder (on a
    # rank the sequence-parallel residual is gathered before it), the
    # decoder's causal self-attention and its cross-attention
    *((f"whisper_train_{who}_encoder", b, 1536, 1536, h, h, 64, 64, False,
       None, None, 0) for who, b, h in (("alone", 4, 16), ("tp2", 2, 8))),
    *((f"whisper_train_{who}_self", b, 64, 64, h, h, 64, 64, True, None,
       None, 0) for who, b, h in (("alone", 4, 16), ("tp2", 2, 8))),
    *((f"whisper_train_{who}_cross", b, 64, 1536, h, h, 64, 64, False, None,
       None, 0) for who, b, h in (("alone", 4, 16), ("tp2", 2, 8))),
]

# phase 16: 4 ranks share the card over gloo; each run (name, model, mesh
# (data, model), plan as candidate_plans builds it, with the 4 x 1024
# batch): chatglm2-6b under tp_dp (head-TP: 2 KV heads over model = 2) and
# longctx_seqshard (sequence-parallel prefill, sequence-sharded decode),
# qwen2-moe-a2.7b under ep_tp (60 experts over data, the all-to-all on
# CUDA tensors staged through the host)
SHARDED_WORLD, SHARDED_CACHE = 4, 64
# phase 16's long batch: 4 x 512-token prompts, 8 new tokens (shorter than
# the other phases' 4 x 1024 and 32, to keep the script under 900 s)
SHARDED_LONG_PROMPT, SHARDED_LONG_NEW = 512, 8
SHARDED_LONG_CACHE = SHARDED_LONG_PROMPT + SHARDED_LONG_NEW + 8
# chatglm2-6b's depth in phase 16: 7 of its 28 layers (14 before phase 19
# was added, which took the script past 900 s)
SHARDED_CHATGLM2_LAYERS = 7
SHARDED_MOE_LAYERS, SHARDED_MOE_CAPACITY = 2, 8.0
SHARDED_RUNS = [
    ("chatglm2 tp_dp", "chatglm2", (2, 2),
     ShardingPlan(batch_axes=("data",), model_axis="model",
                  seq_axes=("model",), mla_absorbed=False), True),
    ("chatglm2 longctx_seqshard", "chatglm2", (1, 4),
     ShardingPlan(batch_axes=(), model_axis="model", mla_absorbed=False,
                  seq_axes=("data", "model")), True),
    ("qwen2_moe ep_tp", "qwen2_moe", (2, 2),
     ShardingPlan(batch_axes=("data",), model_axis="model", ep_axis="data",
                  seq_axes=("model",), mla_absorbed=False), False),
]

# phase 17: training under a plan, 4 ranks sharing the card over gloo; each
# run (name, model, plan as candidate_plans builds it for training on
# {data: 2, model: 2}, optimizer, steps), on the launcher's rolled tokens,
# 4 x 512 a step: chatglm2-6b at full width and 4 layers under tp_dp
# (micro-batches 2) and tp_dp_fsdp (one: fsdp's gathers and reductions
# through gloo run once a micro-batch), AdamW, 2 steps each (3 until phase
# 20 took the script past 900 s), both against one card-alone run at 2
# micro-batches (the same function); qwen2-moe-a2.7b at full width
# and 2 layers (capacity factor 8) under ep_tp_fsdp (Adafactor, as above
# 20B)
SHARDED_TRAIN_LAYERS = {"chatglm2": 4, "qwen2_moe": 2}
SHARDED_TRAIN_BATCH, SHARDED_TRAIN_SEQ = 4, 512
TOL_SHARDED_TRAIN = 1e-4        # loss and grad_norm vs the card alone, relative
_TRAIN_PLAN = dict(batch_axes=("data",), model_axis="model", seq_parallel=True,
                   mla_absorbed=False, remat=True)
SHARDED_TRAIN_RUNS = [
    ("chatglm2 tp_dp", "chatglm2",
     ShardingPlan(**_TRAIN_PLAN, microbatches=2), "adamw", 2),
    ("chatglm2 tp_dp_fsdp", "chatglm2",
     ShardingPlan(**_TRAIN_PLAN, fsdp_axes=("data",)), "adamw", 2),
    ("qwen2_moe ep_tp_fsdp", "qwen2_moe",
     ShardingPlan(**_TRAIN_PLAN, ep_axis="data", fsdp_axes=("data",)),
     "adafactor", 2),
]

# phase 18: the paged engine under dp on {data: 2, model: 2} (batch over
# both axes: one slot row a rank), 4 ranks sharing the card over gloo, and
# the card alone: chatglm2-6b at full width and 14 of its 28 layers on
# 16-token pages, 5 a sequence, in a 48-page pool.  Runs (name, the
# PagedEngineConfig's changes): the 12 serve requests; the shared-prefix mix
# with the prefix cache and 16-token chunks (block-aligned hits, so every
# chunk's prefix is a multiple of 16), then a second wave that extends the
# first's answers; the 12 serve requests with 4 n-gram drafts
SHARDED_PAGED_PLAN = ShardingPlan(batch_axes=("data", "model"))
SHARDED_PAGED_PCFG = dict(max_batch=4, block_size=16, n_blocks=48,
                          max_seq_len=80, max_new_tokens=16)
SHARDED_PAGED_RUNS = {
    "serve": {},
    "waves": dict(prefix_cache=True, chunk_tokens=16,
                  share_partial_tails=False),
    "spec": dict(spec_tokens=4),
}
SHARDED_WAVE, SHARDED_WAVE_NEW = 8, 4   # first-wave requests; new tokens a
#                                         second-wave prompt adds
TOL_POOL = 1e-5                 # x the card alone's largest pool value

# phase 19: Mamba and RWKV-6 blocks under tp_dp on {data: 2, model: 2}
# (batch over data, the blocks over model), 4 ranks sharing the card over
# gloo, against the card alone: model -> (arch, layers kept).  rwkv6-3b at
# full width and 8 of its 32 layers (K4 on each rank's 20 of the 40
# heads); jamba-1.5-large-398b at full width and its first layer (Mamba
# with d_inner 16,384 and a dense MLP of 24,576; in_proj's x columns on
# model-rank 0, its z columns on model-rank 1)
SHARDED_RECURRENT = {"rwkv6": ("rwkv6-3b", 8), "jamba": (JAMBA, 1)}
SHARDED_RECURRENT_PLAN = ShardingPlan(batch_axes=("data",), model_axis="model",
                                      seq_axes=("model",), mla_absorbed=False)
# the prompt lengths of a rank's K4 calls there: the 12 serve requests'
# 16-token prompts padded, and the continuous engine's re-prefilled waves
# (each slot's prompt and its tokens so far)
SHARDED_RECURRENT_T = (16, 20, 21, 23, 24, 25, 28)

# phase 20: whisper-medium under a plan on {data: 2, model: 2}, 4 ranks
# sharing the card over gloo, against the card alone, each drawing the
# weights from the seeded CUDA generator: served at full width and depth
# (24 + 24 layers, 16 over 16 heads of 64: 8 a rank) under tp_dp on phase
# 11's frames and batches through the model API; trained at full width and
# 2 + 2 layers under tp_dp_train (seq_parallel; the encoder-decoder runs no
# remat, as the reference's), 2 AdamW steps of 4 x 64 tokens over 4 x 1,536
# frames (2 + 2 layers: at 4 + 4 the script passed 900 s)
SHARDED_ENCDEC_PLAN = ShardingPlan(batch_axes=("data",), model_axis="model",
                                   seq_axes=("model",), mla_absorbed=False)
SHARDED_ENCDEC_TRAIN_PLAN = ShardingPlan(**_TRAIN_PLAN)
SHARDED_ENCDEC_TRAIN_LAYERS, SHARDED_ENCDEC_TRAIN_STEPS = 2, 2
SHARDED_ENCDEC_TRAIN_SEQ = 64
# phase 21: the dry run (``launch.dryrun``: rank r's program on meta tensors
# over a fake process group), in a subprocess of its own, so that no fake
# group lives beside phases 16-20's gloo ranks, its (cell, rank) runs
# spread over DRYRUN_WORKERS forked processes.  (a) production cells at full
# width on the 16x16 fake mesh, priced at the H100: the hillclimb's three
# climbs, then DRYRUN_CELLS, train_4k and decode_32k of smollm-135m,
# gemma2-27b, minicpm3-4b, qwen2-moe-a2.7b, llama4-maverick-400b-a17b,
# jamba-1.5-large-398b, rwkv6-3b and whisper-medium, less rwkv6-3b's train
# cell (skipped: K4 has no backward on the card) and jamba's: its Mamba
# scan steps through the 4,096 tokens of each of its 63 Mamba layers one
# at a time, forward, again under remat and backward, ~600 s a rank on
# one core of the CPU (PR 34's run of ``--all``, which covers it).
# ``--all`` itself takes well over an hour of one core, past the 45 s
# this phase may give it.  (b) phases 17, 19 and 20's configs, batches,
# plans and f32 on {data: 2, model: 2}, every rank
DRYRUN_CELLS = [(arch, shape) for shape in ("train_4k", "decode_32k")
                for arch in ("smollm-135m", "gemma2-27b", "minicpm3-4b",
                             "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b",
                             "jamba-1.5-large-398b", "rwkv6-3b",
                             "whisper-medium")
                if (arch, shape) not in (("rwkv6-3b", "train_4k"),
                                         ("jamba-1.5-large-398b", "train_4k"))]
DRYRUN_WORKERS = 8
DRYRUN_TIMEOUT = 300.0          # seconds the subprocess may take
# a gradient leaf's absolute error floor beside TOL_TRAIN_GRAD x its
# largest value (tests/torch_sharded_harness.py's GRAD_ATOL): whisper's
# attention key biases have a true gradient of 0 (softmax is
# shift-invariant over keys), so both runs hold rounding noise there
GRAD_FLOOR = 1e-8

FLASH_CASES = [  # name, b, sq, skv, h, kv, d, dv, causal, window, softcap, q_offset
    ("serve_prefill", 4, 16, 16, 9, 3, 64, 64, True, None, None, 0),
    ("long_prefill", 4, LONG_PROMPT, LONG_PROMPT, 9, 3, 64, 64, True, None, None, 0),
    ("s2048", 4, 2048, 2048, 9, 3, 64, 64, True, None, None, 0),
    # the paged path's single-prompt 1k prefills
    ("long_prefill_b1", 1, LONG_PROMPT, LONG_PROMPT, 9, 3, 64, 64, True, None,
     None, 0),
    # paged set b: a 16-token chunk over a 16-token cached prefix
    ("chunk_prefill", 4, 16, 32, 9, 3, 64, 64, True, None, None, 16),
    # the D = 128 instance at chatglm2-6b's widths (group 16: two blocks)
    ("chatglm2_prefill", 2, LONG_PROMPT, LONG_PROMPT, 32, 2, 128, 128, True,
     None, None, 0),
    ("q_offset", 2, 33, 65, 4, 2, 16, 16, True, None, None, 32),
    ("window_softcap", 2, 64, 64, 4, 4, 16, 16, True, 24, 50.0, 0),
    ("non_causal", 2, 48, 48, 2, 1, 32, 32, False, None, None, 0),
    ("d96_dv64", 2, 100, 100, 4, 2, 96, 64, True, None, None, 0),
    ("ragged33", 1, 33, 33, 3, 3, 8, 8, True, None, None, 0),
    ("d128_ragged300", 2, 300, 300, 32, 2, 128, 128, True, None, None, 0),
    ("d128_window_softcap", 1, 77, 77, 12, 2, 128, 128, True, 24, 50.0, 0),
    # the dense serve paths' prefills (D = 128): chatglm2-6b's group 16 and
    # qwen2-1.5b's group 6 at <= 16-token prompts, chatglm2-6b's 4 x 1024
    ("chatglm2_serve_prefill", 4, 16, 16, 32, 2, 128, 128, True, None, None, 0),
    ("chatglm2_long_prefill", 4, LONG_PROMPT, LONG_PROMPT, 32, 2, 128, 128,
     True, None, None, 0),
    ("qwen2_serve_prefill", 4, 16, 16, 12, 2, 128, 128, True, None, None, 0),
    # the shared-prefix paged runs' continuation chunks at chatglm2-6b's
    # widths (one prompt, 8-token blocks, 16-token chunks): a full chunk
    # and an 8-token tail over a 16-token prefix
    ("chatglm2_chunk_prefill", 1, 16, 32, 32, 2, 128, 128, True, None, None,
     16),
    ("chatglm2_chunk_tail", 1, 8, 24, 32, 2, 128, 128, True, None, None, 16),
    # phase 18's one-prompt prefills and 16-token chunks at chatglm2-6b's
    # widths over 16-token pages: a prefix of 0, 32, 48 or 64 cached keys
    # (16 is chatglm2_chunk_prefill)
    *((f"chatglm2_page16_p{p}", 1, 16, p + 16, 32, 2, 128, 128, True, None,
       None, p) for p in (0, 32, 48, 64)),
    # the profile round trip's 8-token chunks on the reduced smollm-135m
    # (group 4, D = 16: ``fa_fwd_simt``): a prompt's first chunk and the
    # second over its 8 cached keys
    ("smollm_reduced_chunk", 1, 8, 8, 4, 1, 16, 16, True, None, None, 0),
    ("smollm_reduced_chunk_next", 1, 8, 16, 4, 1, 16, 16, True, None, None,
     8),
    # gemma2-27b (group 2, D = 128, softcap 50): the long batch's local
    # layers (window 4,096 inside 4,608 tokens) and global layers, and the
    # serve prefill's local layers; minicpm3-4b's MLA prefill (40 heads,
    # D = 96, Dv = 64: the general instance) at 4 x 1024 and at serve size
    ("gemma2_long_prefill", 2, GEMMA2_LONG[0], GEMMA2_LONG[0], 32, 16, 128, 128,
     True, GEMMA2_WINDOW, 50.0, 0),
    ("gemma2_global_prefill", 2, GEMMA2_LONG[0], GEMMA2_LONG[0], 32, 16, 128,
     128, True, None, 50.0, 0),
    ("gemma2_serve_prefill", 4, 16, 16, 32, 16, 128, 128, True, GEMMA2_WINDOW,
     50.0, 0),
    ("minicpm3_long_prefill", 4, LONG_PROMPT, LONG_PROMPT, 40, 40, 96, 64, True,
     None, None, 0),
    ("minicpm3_serve_prefill", 4, 16, 16, 40, 40, 96, 64, True, None, None, 0),
    # qwen2-moe-a2.7b (group 1: 16 over 16 heads) and qwen2-vl-7b (group 7:
    # 28 over 4), D = 128: the long batch's 4 x 1024 and the serve prefill
    ("qwen2_moe_long_prefill", 4, LONG_PROMPT, LONG_PROMPT, 16, 16, 128, 128,
     True, None, None, 0),
    ("qwen2_vl_long_prefill", 4, LONG_PROMPT, LONG_PROMPT, 28, 4, 128, 128,
     True, None, None, 0),
    ("qwen2_moe_serve_prefill", 4, 16, 16, 16, 16, 128, 128, True, None, None, 0),
    ("qwen2_vl_serve_prefill", 4, 16, 16, 28, 4, 128, 128, True, None, None, 0),
    # whisper-medium (group 1, D = 64): the encoder over 1,536 frames and
    # the cross-attention prefill over them (non-causal, Sq != Skv) from
    # the long batch's 448-row and the short batch's 4-row decoder
    # prompts; the long and the short batch's causal decoder
    # self-attention
    ("whisper_encoder", 4, WHISPER_FRAMES, WHISPER_FRAMES, 16, 16, 64, 64,
     False, None, None, 0),
    ("whisper_cross_prefill", 4, WHISPER_LONG[0], WHISPER_FRAMES, 16, 16, 64,
     64, False, None, None, 0),
    ("whisper_short_cross_prefill", 4, WHISPER_SHORT, WHISPER_FRAMES, 16, 16,
     64, 64, False, None, None, 0),
    ("whisper_self_prefill", 4, WHISPER_LONG[0], WHISPER_LONG[0], 16, 16, 64,
     64, True, None, None, 0),
    ("whisper_short_self_prefill", 4, WHISPER_SHORT, WHISPER_SHORT, 16, 16,
     64, 64, True, None, None, 0),
    # llama4-maverick (group 5: 40 over 8 heads, D = 128; bf16 on its main
    # path): the long batch's 4 x 1024 and the serve prefill
    ("llama4_long_prefill", 4, LONG_PROMPT, LONG_PROMPT, 40, 8, 128, 128,
     True, None, None, 0),
    ("llama4_serve_prefill", 4, 16, 16, 40, 8, 128, 128, True, None, None, 0),
    # jamba-1.5-large (group 8: 64 over 8 heads, D = 128, no window; bf16 on
    # its main path): the long batch's 4 x 1024 and the serve prefill
    ("jamba_long_prefill", 4, LONG_PROMPT, LONG_PROMPT, 64, 8, 128, 128,
     True, None, None, 0),
    ("jamba_serve_prefill", 4, 16, 16, 64, 8, 128, 128, True, None, None, 0),
    # phase 16's long batch of chatglm2-6b (4 x 512, D = 128) on the card
    # alone and its shards under phase 16's plans: under tp_dp on {data: 2,
    # model: 2} a rank's 2 rows and 16 over 1 heads (head-TP; also a
    # tp_dp_fsdp rank's in phase 17); under longctx_seqshard on {data: 1,
    # model: 4} rank 3's and rank 0's 128 query rows of every row over all
    # 512 keys, 32 over 2 heads
    ("chatglm2_sharded_long", 4, SHARDED_LONG_PROMPT, SHARDED_LONG_PROMPT, 32,
     2, 128, 128, True, None, None, 0),
    ("chatglm2_tp2_prefill", 2, SHARDED_LONG_PROMPT, SHARDED_LONG_PROMPT, 16,
     1, 128, 128, True, None, None, 0),
    ("chatglm2_sp4_prefill", 4, SHARDED_LONG_PROMPT // 4, SHARDED_LONG_PROMPT,
     32, 2, 128, 128, True, None, None, 3 * SHARDED_LONG_PROMPT // 4),
    ("chatglm2_sp4_prefill_r0", 4, SHARDED_LONG_PROMPT // 4,
     SHARDED_LONG_PROMPT, 32, 2, 128, 128, True, None, None, 0),
    # phase 17's (GRAD_CASES), forward alone; chatglm2_tp2_prefill above is
    # a tp_dp_fsdp rank's
    *(c for c in GRAD_CASES if c[0].endswith(("_alone", "_micro"))
      or c[0] == "qwen2_moe_train_tp2"),
    # phase 20's tp_dp rank (2 rows, 8 over 8 heads of 64): the encoder
    # over 1,536 frames (also the train step's), the short and long
    # batches' decoder self-attention and cross-attention prefills; the
    # train step's decoder forwards, on a rank and on the card alone
    # (GRAD_CASES; the card alone's encoder is whisper_encoder's)
    ("whisper_tp2_encoder", 2, WHISPER_FRAMES, WHISPER_FRAMES, 8, 8, 64, 64,
     False, None, None, 0),
    ("whisper_tp2_short_self", 2, WHISPER_SHORT, WHISPER_SHORT, 8, 8, 64, 64,
     True, None, None, 0),
    ("whisper_tp2_short_cross", 2, WHISPER_SHORT, WHISPER_FRAMES, 8, 8, 64,
     64, False, None, None, 0),
    ("whisper_tp2_long_self", 2, WHISPER_LONG[0], WHISPER_LONG[0], 8, 8, 64,
     64, True, None, None, 0),
    ("whisper_tp2_long_cross", 2, WHISPER_LONG[0], WHISPER_FRAMES, 8, 8, 64,
     64, False, None, None, 0),
    *(c for c in GRAD_CASES if c[0].startswith("whisper_train_")
      and c[0].endswith(("_self", "_cross"))),
]
FLASH_TIMED = ("serve_prefill", "long_prefill", "s2048", "long_prefill_b1",
               "chunk_prefill", "chatglm2_prefill", "chatglm2_serve_prefill",
               "chatglm2_long_prefill", "chatglm2_chunk_prefill",
               "chatglm2_chunk_tail", "chatglm2_page16_p0",
               "chatglm2_page16_p48", "smollm_reduced_chunk",
               "smollm_reduced_chunk_next", "qwen2_serve_prefill",
               "gemma2_long_prefill", "gemma2_global_prefill",
               "gemma2_serve_prefill", "minicpm3_long_prefill",
               "minicpm3_serve_prefill", "qwen2_moe_long_prefill",
               "qwen2_vl_long_prefill", "qwen2_moe_serve_prefill",
               "qwen2_vl_serve_prefill", "whisper_encoder",
               "whisper_cross_prefill", "whisper_short_cross_prefill",
               "llama4_long_prefill", "llama4_serve_prefill",
               "jamba_long_prefill", "jamba_serve_prefill",
               "chatglm2_tp2_prefill", "chatglm2_sp4_prefill")
DECODE_CASES = [  # name, b, s, h, kv, d, dv, softcap, window, kv_len
    ("serve_decode", 4, 64, 9, 3, 64, 64, None, None, [24, 20, 17, 31]),
    ("long_decode", 4, LONG_CACHE, 9, 3, 64, 64, None, None, [1041] * 4),
    ("s4096_ragged", 4, 4096, 9, 3, 64, 64, None, None, [4096, 3001, 1500, 7]),
    ("window", 2, 128, 8, 8, 16, 16, None, 40, [128, 77]),
    ("softcap", 3, 64, 6, 3, 8, 8, 50.0, None, [64, 33, 2]),
    ("kv_len_1", 4, 256, 9, 3, 64, 64, None, None, [1, 1, 1, 1]),
    # the edges of the 16-way split at S = 1088: one position, exactly one
    # split (32) and one past, one tile in each split (512) and one past
    ("split_edges", 6, LONG_CACHE, 9, 3, 64, 64, None, None,
     [1, 32, 33, 512, 513, 1041]),
    # window starts 841 and 500 inside a tile; 150 and 33 shorter than it
    ("window_in_split", 4, LONG_CACHE, 9, 3, 64, 64, None, 200,
     [1041, 700, 150, 33]),
    # kv_len past the 128 slots: the window starts at kv_len - 40 = 110
    ("window_past_slots", 2, 128, 8, 8, 16, 16, None, 40, [150, 77]),
    # past the slots, and a row with no valid key (0, as the reference)
    ("empty_row", 2, 80, 4, 2, 64, 64, None, None, [90, 0]),
    # the dense serve paths' decode steps (D = 128, the general instance):
    # chatglm2-6b's serve and long batch, qwen2-1.5b's serve batch
    ("chatglm2_serve_decode", 4, 64, 32, 2, 128, 128, None, None,
     [24, 20, 17, 31]),
    ("chatglm2_long_decode", 4, LONG_CACHE, 32, 2, 128, 128, None, None,
     [1041] * 4),
    ("qwen2_serve_decode", 4, 64, 12, 2, 128, 128, None, None,
     [24, 20, 17, 31]),
    # gemma2-27b's global layers in the long batch's decode (group 2, D =
    # 128, softcap 50)
    ("gemma2_long_decode", 2, GEMMA2_CACHE, 32, 16, 128, 128, 50.0, None,
     list(GEMMA2_LONG)),
    # qwen2-moe-a2.7b (group 1) and qwen2-vl-7b (group 7) at D = 128: the
    # long batch's decode and the serve decode
    ("qwen2_moe_long_decode", 4, LONG_CACHE, 16, 16, 128, 128, None, None,
     [1041] * 4),
    ("qwen2_vl_long_decode", 4, LONG_CACHE, 28, 4, 128, 128, None, None,
     [1041] * 4),
    ("qwen2_moe_serve_decode", 4, 64, 16, 16, 128, 128, None, None,
     [24, 20, 17, 31]),
    ("qwen2_vl_serve_decode", 4, 64, 28, 4, 128, 128, None, None,
     [24, 20, 17, 31]),
    # gemma2-27b's serve decode (global layers at cache_len 64, softcap 50)
    ("gemma2_serve_decode", 4, 64, 32, 16, 128, 128, 50.0, None,
     [24, 20, 17, 31]),
    # whisper-medium (group 1, D = 64): cross-attention over all 1,536
    # memory rows, the long batch's first self-attention step and the
    # short batch's steps
    ("whisper_cross_decode", 4, WHISPER_FRAMES, 16, 16, 64, 64, None, None,
     [WHISPER_FRAMES] * 4),
    ("whisper_self_decode", 4, WHISPER_LONG_CACHE, 16, 16, 64, 64, None, None,
     [n + 1 for n in WHISPER_LONG]),
    ("whisper_short_self_decode", 4, WHISPER_SHORT_CACHE, 16, 16, 64, 64,
     None, None, [WHISPER_SHORT + 1, 9, 14, WHISPER_SHORT_CACHE]),
    # llama4-maverick (group 5, D = 128): the long batch's decode and the
    # serve decode
    ("llama4_long_decode", 4, LONG_CACHE, 40, 8, 128, 128, None, None,
     [1041] * 4),
    ("llama4_serve_decode", 4, 64, 40, 8, 128, 128, None, None,
     [24, 20, 17, 31]),
    # jamba-1.5-large (group 8, D = 128): the long batch's first decode step
    # (4 x kv 1041) and the serve decode
    ("jamba_long_decode", 4, LONG_CACHE, 64, 8, 128, 128, None, None,
     [1041] * 4),
    ("jamba_serve_decode", 4, 64, 64, 8, 128, 128, None, None,
     [24, 20, 17, 31]),
    # phase 16: chatglm2-6b's 4 x 512 batch halfway through its 8 decode
    # steps, on the card alone and on a tp_dp rank (2 rows, 16 over 1 heads
    # of 128: head-TP)
    ("chatglm2_sharded_long_decode", 4, SHARDED_LONG_CACHE, 32, 2, 128, 128,
     None, None, [SHARDED_LONG_PROMPT + SHARDED_LONG_NEW // 2] * 4),
    ("chatglm2_tp2_decode", 2, SHARDED_LONG_CACHE, 16, 1, 128, 128, None,
     None, [SHARDED_LONG_PROMPT + SHARDED_LONG_NEW // 2] * 2),
    # phase 16's serve batches on a rank (2 rows, cache_len 64): chatglm2-6b
    # under tp_dp (16 over 1 heads of 128), qwen2-moe-a2.7b under ep_tp (8
    # over 8)
    ("chatglm2_tp2_serve_decode", 2, SHARDED_CACHE, 16, 1, 128, 128, None,
     None, [24, 20]),
    ("qwen2_moe_tp2_serve_decode", 2, SHARDED_CACHE, 8, 8, 128, 128, None,
     None, [24, 20]),
    # phase 20's tp_dp rank (2 rows, 8 over 8 heads of 64): the short and
    # long batches' self-attention steps and the cross-attention over all
    # 1,536 memory rows
    ("whisper_tp2_short_self_decode", 2, WHISPER_SHORT_CACHE, 8, 8, 64, 64,
     None, None, [WHISPER_SHORT + 1, WHISPER_SHORT_CACHE]),
    ("whisper_tp2_long_self_decode", 2, WHISPER_LONG_CACHE, 8, 8, 64, 64,
     None, None, [WHISPER_LONG[0] + 1, WHISPER_LONG[1] + 1]),
    ("whisper_tp2_cross_decode", 2, WHISPER_FRAMES, 8, 8, 64, 64, None, None,
     [WHISPER_FRAMES] * 2),
]
DECODE_TIMED = ("serve_decode", "long_decode", "s4096_ragged",
                "chatglm2_serve_decode", "chatglm2_long_decode",
                "qwen2_serve_decode", "gemma2_long_decode",
                "qwen2_moe_long_decode", "qwen2_vl_long_decode",
                "qwen2_moe_serve_decode", "qwen2_vl_serve_decode",
                "gemma2_serve_decode", "whisper_cross_decode",
                "whisper_self_decode", "llama4_long_decode",
                "llama4_serve_decode", "jamba_long_decode",
                "jamba_serve_decode", "chatglm2_tp2_decode")
# gemma2-27b's local layers in the long batch's decode: a ring of 4,096
# slots after the wrap, as DECODE_CASES but with kv_len the query's
# position; K3 over the first min(kv_len + 1, w) slots (``ring_kernel``)
# against the plain ``ring_decode`` (``ring_plain``)
RING_CASES = [
    ("gemma2_ring_decode", 2, GEMMA2_WINDOW, 32, 16, 128, 128, 50.0,
     GEMMA2_WINDOW, [GEMMA2_LONG[0] + 12, GEMMA2_LONG[1] + 10]),
]
LONG_PAGE, LONG_PAGES = 16, 66        # ceil((1024 + 32) / 16) pages a sequence
PAGED_CASES = [  # name, entry, b, t, h, kv, d, dv, bs, nb, n, softcap, lengths
    # the JAX package's CASES of tests/test_paged_attention.py
    ("jax_case0", "decode", 2, 1, 4, 2, 16, 16, 8, 4, 16, None, None),
    ("jax_case1", "decode", 3, 1, 6, 3, 8, 8, 16, 3, 24, 50.0, None),
    ("jax_case2", "decode", 1, 1, 8, 8, 32, 32, 4, 6, 32, None, None),
    ("jax_case3", "decode", 4, 1, 16, 2, 64, 64, 16, 2, 48, None, None),
    ("paged_serve_decode", "decode", 4, 1, 9, 3, 64, 64, 8, 4, 55, None,
     [24, 20, 17, 31]),
    ("window_t1", "window", 4, 1, 9, 3, 64, 64, 8, 4, 55, None, None),
    ("window_t2", "window", 4, 2, 9, 3, 64, 64, 8, 4, 55, None, None),
    ("window_t4", "window", 4, 4, 9, 3, 64, 64, 8, 4, 55, 30.0, None),
    ("window_t5", "window", 4, 5, 9, 3, 64, 64, 8, 4, 55, None, None),
    ("kv_len_1", "decode", 4, 1, 9, 3, 64, 64, 8, 4, 55, None, [1, 1, 1, 1]),
    ("free_slot", "decode", 4, 1, 9, 3, 64, 64, 8, 4, 55, None, [24, 9, 31, 1]),
    ("permuted_table", "window", 4, 3, 9, 3, 64, 64, 16, 8, 40, None, None),
    ("poisoned_tail", "window", 4, 5, 9, 3, 64, 64, 8, 6, 40, None,
     [6, 11, 3, 15]),
    ("d96_dv64", "window", 2, 3, 4, 2, 96, 64, 8, 4, 16, None, None),
    ("paged_long_decode", "decode", 4, 1, 9, 3, 64, 64, LONG_PAGE, LONG_PAGES,
     4 * LONG_PAGES + 1, None, [LONG_PROMPT + 17] * 4),
    ("paged_long_window", "window", 4, 5, 9, 3, 64, 64, LONG_PAGE, LONG_PAGES,
     4 * LONG_PAGES + 1, None, [LONG_PROMPT + 12] * 4),
    # 66 16-token pages split 14 ways (5 pages, 80 positions each): limits
    # on a page boundary (16) and one past, on a split boundary (80) and
    # one past, the whole table (1056)
    ("page_edges", "decode", 6, 1, 9, 3, 64, 64, LONG_PAGE, LONG_PAGES,
     6 * LONG_PAGES + 1, None, [1, 16, 17, 80, 81, 1056]),
    ("page_edges_t5", "window", 6, 5, 9, 3, 64, 64, LONG_PAGE, LONG_PAGES,
     6 * LONG_PAGES + 1, None, [75, 76, 11, 12, 0, 1051]),
    # D = 128 (the general instance): chatglm2-6b's paged serve decode over
    # 8-token pages and a long decode over 16-token pages; qwen2-1.5b's
    ("chatglm2_paged_serve_decode", "decode", 4, 1, 32, 2, 128, 128, 8, 4, 55,
     None, [24, 20, 17, 31]),
    ("chatglm2_paged_long_decode", "decode", 4, 1, 32, 2, 128, 128, LONG_PAGE,
     LONG_PAGES, 4 * LONG_PAGES + 1, None, [LONG_PROMPT + 17] * 4),
    ("qwen2_paged_serve_decode", "decode", 4, 1, 12, 2, 128, 128, 8, 4, 55,
     None, [24, 20, 17, 31]),
    # qwen2-moe-a2.7b's (group 1) and qwen2-vl-7b's (group 7) paged decode
    ("qwen2_moe_paged_serve_decode", "decode", 4, 1, 16, 16, 128, 128, 8, 4,
     55, None, [24, 20, 17, 31]),
    ("qwen2_vl_paged_serve_decode", "decode", 4, 1, 28, 4, 128, 128, 8, 4, 55,
     None, [24, 20, 17, 31]),
    # llama4-maverick's paged decode (group 5, D = 128) over 8-token pages
    ("llama4_paged_serve_decode", "decode", 4, 1, 40, 8, 128, 128, 8, 4, 55,
     None, [24, 20, 17, 31]),
    # the profile round trip on the reduced smollm-135m (group 4, D = 16):
    # its T = 5 verify windows over 8-token pages of a 977-page pool, at
    # lengths the run reaches (an idle slot at 0), and a decode at its widths
    ("smollm_reduced_verify", "window", 4, 5, 4, 1, 16, 16, 8, 8, 977, None,
     [17, 29, 0, 22]),
    ("smollm_reduced_decode", "decode", 4, 1, 4, 1, 16, 16, 8, 8, 977, None,
     [18, 30, 1, 23]),
    # phase 18: chatglm2-6b's paged engine under dp (16-token pages, 5 a
    # sequence, a 48-page pool): a rank's one row and the card alone's 4,
    # the decode and the 4-draft verify window
    ("chatglm2_dp_rank_decode", "decode", 1, 1, 32, 2, 128, 128, 16, 5, 48,
     None, [37]),
    ("chatglm2_dp_rank_verify", "window", 1, 5, 32, 2, 128, 128, 16, 5, 48,
     None, [30]),
    ("chatglm2_dp_alone_decode", "decode", 4, 1, 32, 2, 128, 128, 16, 5, 48,
     None, [24, 20, 17, 31]),
    ("chatglm2_dp_alone_verify", "window", 4, 5, 32, 2, 128, 128, 16, 5, 48,
     None, [17, 29, 0, 22]),
]
PAGED_TIMED = ("paged_serve_decode", "paged_long_decode", "paged_long_window",
               "chatglm2_paged_serve_decode", "chatglm2_paged_long_decode",
               "qwen2_paged_serve_decode", "qwen2_moe_paged_serve_decode",
               "qwen2_vl_paged_serve_decode", "llama4_paged_serve_decode",
               "smollm_reduced_verify", "chatglm2_dp_rank_decode",
               "chatglm2_dp_rank_verify")
# cases timed in bf16, the dtype of their main path (every other one in f32)
BF16_TIMED = ("llama4_long_prefill", "llama4_serve_prefill",
              "llama4_long_decode", "llama4_serve_decode",
              "llama4_paged_serve_decode", "jamba_long_prefill",
              "jamba_serve_prefill", "jamba_long_decode", "jamba_serve_decode")
WKV6_CASES = [  # name, b, t, h, d, dv, chunk, decay_scale, w_max, s0
    ("rwkv_serve_prefill", 4, 16, 40, 64, 64, 32, 2.0, None, False),
    ("rwkv_long_prefill", 4, LONG_PROMPT, 40, 64, 64, 32, 2.0, None, False),
    ("ragged33", 4, 33, 40, 64, 64, 32, 2.0, None, False),
    ("ragged50_chunk16", 2, 50, 40, 64, 64, 16, 2.0, None, False),
    ("t7_lt_chunk", 4, 7, 40, 64, 64, 32, 2.0, None, False),
    ("strong_decay", 2, 48, 40, 64, 64, 16, 4.0, 1e-6, False),
    ("given_s0", 4, 64, 40, 64, 64, 32, 2.0, None, True),
    # K4 splits Dv over 4 blocks: 2, 2, 2, 0 columns and 1, 1, 0, 0 columns
    ("dv6_split", 2, 40, 3, 16, 6, 32, 2.0, None, True),
    ("dv2_empty_blocks", 2, 33, 2, 16, 2, 32, 2.0, None, False),
    # phase 19's rank shapes: rwkv6-3b's 2 rows a data shard over 20 of its
    # 40 heads a model shard
    *((f"rwkv_tp2_rank_t{t}", 2, t, 20, 64, 64, 32, 2.0, None, False)
      for t in SHARDED_RECURRENT_T),
]
WKV6_TIMED = ("rwkv_serve_prefill", "rwkv_long_prefill", "rwkv_tp2_rank_t28")
WINDOW_PARITY_LAYERS = 2       # gemma2-27b card vs CPU: one local, one global
TIMED = {"flash_attention": "long_prefill", "decode_attention": "long_decode",
         "paged_attention": "paged_long_decode", "wkv6": "rwkv_long_prefill"}
COLD = {"flash_attention": "fa_fwd", "decode_attention": "dec_fwd",
        "paged_attention": "paged_fwd", "wkv6": "wkv6_fwd_kernel"}
FLUSH_BYTES = 64 * 2**20              # written between launches: > the 50 MB L2
RWKV_PARITY_LAYERS = 4                # card vs CPU logits: the first 4 of 32
PAGED_BUDGET, PREEMPT_BUDGET = "2e7", "3e6"
DENSE_PARITY_LAYERS = 2               # card vs CPU logits: the first 2 of 28
# phase 10's paged pool: 4 slots of 8 pages of 8 tokens and more at either
# model's f32 KV (qwen2-moe-a2.7b: 3.1 MB a page, so 2e7 B would buy 6)
MOE_VLM_BUDGET = "1.1e8"
# phase 8's live cluster on chatglm2-6b (``serve --replicas 2 --paged``):
# name -> (workload, ``serve.serve_cluster`` keywords)
CLUSTER_LIVE = {
    "a_least_loaded": ("alpaca", {"router": "least_loaded"}),
    "b_slo_aware": ("alpaca", {"router": "slo_aware"}),
    "c_prefix_affinity": ("shared-prefix", {"router": "prefix_affinity",
                                            "prefix_cache": True,
                                            "chunk_tokens": 16}),
}
# where the observed runs of phases 8 and 14 write their trace, metrics
# JSON and cost profile
OBS_DIR = ROOT / "chiprun_out" / "obs"
# phase 8: the live cluster's run whose profile is saved and read back
CLUSTER_PROFILED = "a_least_loaded"
PRICING_QUANTILE = 0.95
# phase 8: cycles of the ``--paged`` run untraced and traced, against the
# reference's profiling-overhead budget
OVERHEAD_CYCLES, PROFILE_BUDGET = 6, 0.05
# phase 8: ``ci.sh``'s profile round trip on the reduced smollm-135m
PROFILE_ROUND_TRIP = ["--paged", "--speculate", "--chunk-tokens", "8",
                      "--requests", "8"]
# phase 14's simulated cluster: name -> serve flags after
# ``--arch chatglm2-6b --replicas 4 --device cuda``
CLUSTER_SIM = {
    "round_robin": ["--router", "round_robin"],
    "least_loaded": ["--router", "least_loaded"],
    "prefix_affinity": ["--router", "prefix_affinity"],
    "slo_aware": ["--router", "slo_aware"],
    "autoscale_bursty": ["--autoscale", "--workload", "bursty"],
    "fleet_joint": ["--models", "chatglm2-6b:0.6,qwen2-1.5b:0.4",
                    "--autoscale", "--fleet", "joint"],
    "fleet_independent": ["--models", "chatglm2-6b:0.6,qwen2-1.5b:0.4",
                          "--autoscale", "--fleet", "independent"],
    "faults": ["--fault-crash", "2.5:1", "--fault-mtbf", "20",
               "--fault-mttr", "2", "--brownout-tiers", "batch"],
}
PREDICTORS: dict = {}    # vocab -> the fitted length predictor (``predictor``)
PAGED_SETS = {   # name -> serve flags after SERVE_ARGS
    "a_paged": ["--paged", "--kv-budget", PAGED_BUDGET],
    "b_prefix_chunked": ["--prefix-cache", "--workload", "shared-prefix",
                         "--chunk-tokens", "16", "--kv-budget", PAGED_BUDGET],
    "c_speculate": ["--speculate", "--spec-tokens", "4", "--kv-budget",
                    PAGED_BUDGET],
    "d_preempt": ["--paged", "--preempt", "--kv-budget", PREEMPT_BUDGET],
}


def predictor(vocab: int):
    """A copy of ``serve.fit_predictor(vocab, "cuda")``, fitted once per
    vocab: each run takes a fresh copy, since its monitor updates the
    predictor online."""
    if vocab not in PREDICTORS:
        PREDICTORS[vocab] = serve.fit_predictor(vocab, "cuda")
    return copy.deepcopy(PREDICTORS[vocab])


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def call_ms(fn) -> float:
    """Median milliseconds of one call of ``fn`` between two CUDA events,
    over N_TIMED calls: device time plus any wait for the host's launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_kernels(fn, n: int = 1):
    """Device activities (kernels, copies) of ``n`` calls of ``fn`` as
    torch.profiler records them: [(name, microseconds)].  The profiler can
    lose a run of a window's first activities (all of a one-kernel window,
    in most tries once the process has served for minutes), and keeps every
    activity after the first it keeps.  So each window opens with PAD_SPINS
    spin kernels (``torch.cuda._sleep``), dropped from the result: one of
    them seen means every activity of ``fn`` was recorded; none seen is
    retried."""
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD_SPINS):
                torch.cuda._sleep(50)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kern = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        spins = sum(SPIN in name for name, _ in kern)
        PROFILER["windows"] += 1
        PROFILER["max_lost"] = max(PROFILER["max_lost"], PAD_SPINS - spins)
        if spins:
            return [(name, us) for name, us in kern if SPIN not in name]
        PROFILER["all_lost"] += 1
    fail(f"the profiler lost all {PAD_SPINS} spin kernels that open its "
         "window, five times")


def timed(fn, per_call: int | None = None) -> dict:
    """Device ms per call (profiler: the mean activity times the activities
    of one call, ``per_call`` where the caller knows it, else those of one
    profiled call) and the event-timed ms per call."""
    if per_call is None:
        per_call = len(device_kernels(fn))
    kern = device_kernels(fn, N_TIMED)
    return {"ms": sum(us for _, us in kern) / len(kern) * per_call / 1e3,
            "call_ms": call_ms(fn), "launches_per_call": per_call}


def cold_ms(fn, symbol: str) -> float:
    """Mean device ms of the kernel whose name holds ``symbol`` with
    FLUSH_BYTES written between launches, so its inputs come from HBM as
    the serve step finds them; only the kernel's own activities count."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")

    def step():
        flush.fill_(1.0)
        fn()
    kern = [us for name, us in device_kernels(step, N_TIMED) if symbol in name]
    if not kern:
        fail(f"cold timing: the profiler saw no {symbol} kernel")
    return sum(kern) / len(kern) / 1e3


def randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def flash_inputs(case, dtype, gen):
    _, b, sq, skv, h, kv, d, dv, causal, window, cap, qoff = case
    q = randn(gen, b, sq, h, d, dtype=dtype)
    k = randn(gen, b, skv, kv, d, dtype=dtype)
    v = randn(gen, b, skv, kv, dv, dtype=dtype)
    return (q, k, v), dict(causal=causal, window=window, softcap=cap,
                           q_offset=qoff)


def decode_inputs(case, dtype, gen):
    _, b, s, h, kv, d, dv, cap, window, kv_len = case
    q = randn(gen, b, h, d, dtype=dtype)
    k = randn(gen, b, s, kv, d, dtype=dtype)
    v = randn(gen, b, s, kv, dv, dtype=dtype)
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return (q, k, v, kl), dict(softcap=cap, window=window)


def flash_cost(case, dtype):
    """(bytes, operations) the flash function needs for this case."""
    _, b, sq, skv, h, kv, d, dv, causal, window, cap, qoff = case
    size = torch.finfo(dtype).bits // 8
    pairs = 0
    for i in range(sq):
        qa = qoff + i
        hi = min(skv - 1, qa) if causal else skv - 1
        lo = max(0, qa - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    nbytes = size * (b * sq * h * (d + dv) + b * skv * kv * (d + dv))
    return nbytes, 2.0 * (d + dv) * pairs * b * h


def paged_inputs(case, dtype, gen):
    """(q, k_pool, v_pool, block_tables, kv_len) for a PAGED_CASES entry:
    a permuted table over blocks 1..n-1 (block 0 is the null block), the
    given lengths or random ones; ``free_slot`` points its last row at the
    null block, ``poisoned_tail`` points every page past the valid ones at
    the null block and fills it with +-1e3."""
    name, entry, b, t, h, kv, d, dv, bs, nb, n, cap, lens = case
    q = randn(gen, b, t, h, d, dtype=dtype)
    kp = randn(gen, n, bs, kv, d, dtype=dtype)
    vp = randn(gen, n, bs, kv, dv, dtype=dtype)
    perm = 1 + torch.randperm(n - 1, generator=gen, device="cuda")
    bt = perm[:b * nb].reshape(b, nb).to(torch.int32).contiguous()
    lo = 1 if entry == "decode" else 0
    hi = nb * bs + 1 if entry == "decode" else nb * bs - t + 1
    kl = torch.tensor(lens, dtype=torch.int32, device="cuda") if lens else \
        torch.randint(lo, hi, (b,), generator=gen, device="cuda").to(torch.int32)
    if name == "free_slot":
        bt[-1] = 0
    if name == "poisoned_tail":
        for i, n_len in enumerate(lens):
            bt[i, -(-(n_len + t) // bs):] = 0
        kp[0], vp[0] = 1e3, -1e3
    if entry == "decode":
        q = q[:, 0].contiguous()
    return (q, kp, vp, bt, kl), dict(softcap=cap)


def paged_fns(case):
    return (paged_decode_attention, paged_decode_attention_reference) \
        if case[1] == "decode" else \
        (paged_window_attention, paged_window_attention_reference)


def paged_cost(case, dtype):
    """(bytes, operations) paged attention needs for this case's lengths:
    the valid K/V rows (those of the longest row of each sequence), q, the
    output, the table entries read and kv_len; 2 (D + Dv) operations per
    visible (query row, key) pair."""
    name, entry, b, t, h, kv, d, dv, bs, nb, n, cap, lens = case
    size = torch.finfo(dtype).bits // 8
    last = [n_len - 1 for n_len in lens] if entry == "decode" else lens
    rows = sum(base + t for base in last)                 # keys per sequence
    pairs = sum(base + i + 1 for base in last for i in range(t))
    pages = sum(-(-(base + t) // bs) for base in last)
    nbytes = size * (rows * kv * (d + dv) + b * t * h * (d + dv)) \
        + 4 * (pages + b)
    return nbytes, 2.0 * (d + dv) * pairs * h


def decode_cost(case, dtype):
    _, b, s, h, kv, d, dv, cap, window, kv_len = case
    size = torch.finfo(dtype).bits // 8
    rows = sum(min(n, window) if window else n for n in kv_len)
    nbytes = size * (rows * kv * (d + dv) + b * h * (d + dv)) + 4 * b
    return nbytes, 2.0 * (d + dv) * rows * h


def ring_kernel(q, k, v, kv_len, *, softcap=None, window=None):
    """Decode over a ring of w slots as ``attention.attn_decode`` runs it
    (``ring_decode_attention``: K3 over the first min(kv_len + 1, w) slots,
    no window)."""
    return ring_decode_attention(q, k, v, kv_len, softcap=softcap)


def ring_plain(q, k, v, kv_len, *, softcap=None, window=None):
    """The plain ring decode (the reference's ``_ring_decode``) at query
    position kv_len."""
    cfg = replace(get_config("gemma2-27b"), attn_softcap=softcap)
    return ring_decode(cfg, q, {"k": k, "v": v}, kv_len, window)


def wkv6_inputs(case, dtype, gen):
    """r, k, v in ``dtype``; w = exp(-exp(N * decay_scale)) (clipped to
    ``w_max``), u and s0 in f32, as the JAX package's wkv6 tests draw them."""
    _, b, t, h, d, dv, chunk, scale, w_max, with_s0 = case
    r = randn(gen, b, t, h, d, dtype=torch.float32) * 0.5
    k = randn(gen, b, t, h, d, dtype=torch.float32) * 0.5
    v = randn(gen, b, t, h, dv, dtype=torch.float32)
    w = torch.exp(-torch.exp(randn(gen, b, t, h, d, dtype=torch.float32) * scale))
    if w_max is not None:
        w = w.clamp_max(w_max)
    u = randn(gen, h, d, dtype=torch.float32) * 0.3
    s0 = randn(gen, b, h, d, dv, dtype=torch.float32) if with_s0 else None
    return (r.to(dtype), k.to(dtype), v.to(dtype), w, u, s0), dict(chunk=chunk)


def wkv6_cost(case, dtype):
    """(bytes, operations) of the chunked WKV6 for this case: r, k, v, w
    (f32), u and s0 read once, out and the f32 state written once; 2
    operations per multiply-add of the chunk form (for n valid rows of a
    chunk: n D Dv for the state read, n(n+1)/2 (D + Dv) for the
    intra-chunk matrix and its product, D Dv (n + 1) for the state update),
    the exponentials not counted."""
    _, b, t, h, d, dv, chunk, _, _, with_s0 = case
    size = torch.finfo(dtype).bits // 8
    nbytes = size * b * t * h * (2 * d + 2 * dv) + 4 * b * t * h * d \
        + 4 * h * d + 4 * b * h * d * dv * (2 if with_s0 else 1)
    c = min(chunk, t)
    fma = 0
    for t0 in range(0, t, c):
        n = min(c, t - t0)
        fma += n * d * dv + n * (n + 1) // 2 * (d + dv) + d * dv * (n + 1)
    return nbytes, 2.0 * fma * b * h


def bound(nbytes, ops, dtype):
    t_bytes, t_ops = nbytes / H100.hbm_bw * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"name": torch.cuda.get_device_name(0), "smi": smi}


def phase_build() -> dict:
    t0 = time.perf_counter()
    took = build.build_all()
    wall = time.perf_counter() - t0
    print(f"[build] {len(took)} kernels in {wall:.1f}s wall "
          f"({', '.join(f'{n} {s:.1f}s' for n, s in took.items())})", flush=True)
    for name in build.KERNELS:
        regs = [ln.split("info    :")[-1].strip()
                for ln in build.build_log(name).splitlines() if "registers" in ln]
        print(f"[build] {name}: {'; '.join(regs)}", flush=True)
    return {"wall_s": wall, "per_kernel_s": took, "fa_fwd_mma": mma_check(),
            "wkv6_fwd_kernel": wkv6_check()}


def ptxas_info(kernel: str, symbol: str) -> dict:
    """Spill-store bytes and registers of each function of ``kernel``'s
    library whose name holds ``symbol``, from its build log (-Xptxas -v).
    Fails if none is named."""
    funcs, cur = {}, None
    for ln in build.build_log(kernel).splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1] if symbol in ln else None
        elif cur and "spill stores" in ln:
            funcs[cur] = {"spill_bytes": int(ln.split("bytes spill stores")[0]
                                             .split(",")[-1])}
        elif cur in funcs and "registers" in ln:
            funcs[cur]["registers"] = int(ln.split("Used")[1].split("registers")[0])
    if not funcs:
        fail(f"{kernel}'s build log names no {symbol} instance")
    return funcs


def wkv6_smem_bytes(c: int, d: int, dv: int) -> int:
    """K4's dynamic shared memory a block (``smem_floats`` of
    ``csrc/wkv6.cu``): r, k, cw with rows of d + 1, the block's
    ceil(dv / 4) columns of v and of S, A twice with rows of c + 1, u and
    the chunk decay."""
    nv = -(-dv // 4)
    return 4 * (3 * c * (d + 1) + c * nv + 2 * c * (c + 1) + d * nv + 2 * d)


def wkv6_check() -> dict:
    """K4's instances (f32, bf16): no spill store (fails otherwise), their
    registers, the shared bytes a block at the main path's C = 32, D = Dv =
    64, and the blocks an SM those allow (65,536 registers in 256-register
    warp units, 228 KB of shared memory with 1 KB reserved a block, 64
    warps)."""
    smem = wkv6_smem_bytes(32, 64, 64)
    funcs = ptxas_info("wkv6", "wkv6_fwd_kernel")
    for fn, rec in funcs.items():
        warp_regs = -(-rec["registers"] * 32 // 256) * 256
        rec["smem_bytes_d64"] = smem
        rec["blocks_per_sm"] = min(65536 // (8 * warp_regs),
                                   228 * 1024 // (smem + 1024), 64 // 8)
        print(f"[build] {fn}: {rec['registers']} registers, "
              f"{rec['spill_bytes']} bytes spilled, {smem} bytes of shared "
              f"memory at D = Dv = 64, {rec['blocks_per_sm']} blocks an SM",
              flush=True)
        if rec["spill_bytes"]:
            fail(f"{fn}: spills")
    return funcs


def mma_check() -> dict:
    """Per tensor-core instance of flash attention (``fa_fwd_mma``): its
    spill stores from the build log and its HMMA instructions in the
    library's SASS.  Fails on a spill, on an instance without HMMA, or on
    no instance at all."""
    funcs = ptxas_info("flash_attention", "fa_fwd_mma")
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    if cuobjdump.is_file():
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build.library_path("flash_attention"))],
                              capture_output=True, text=True, check=True).stdout
        cur = None
        for ln in sass.splitlines():
            if "Function :" in ln:
                cur = ln.split("Function :")[1].strip()
                if cur in funcs:
                    funcs[cur]["hmma"] = 0
            elif cur in funcs and "HMMA" in ln:
                funcs[cur]["hmma"] += 1
    for fn, rec in funcs.items():
        print(f"[build] {fn}: {rec['spill_bytes']} bytes spilled, "
              f"{rec.get('hmma', 'not measured (no cuobjdump)')} HMMA "
              "instructions in its SASS", flush=True)
        if rec["spill_bytes"] or rec.get("hmma", 1) == 0:
            fail(f"{fn}: spills or no tensor-core instruction")
    return funcs


def phase_parity() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    out, bad = {}, []
    paged = [(case, *paged_fns(case)) for case in PAGED_CASES]
    for kernel, cases, make in (
            ("flash_attention", [(c, flash_attention, flash_attention_reference)
                                 for c in FLASH_CASES], flash_inputs),
            ("decode_attention", [(c, decode_attention,
                                   decode_attention_reference)
                                  for c in DECODE_CASES]
             + [(c, ring_kernel, ring_plain) for c in RING_CASES],
             decode_inputs),
            ("paged_attention", paged, paged_inputs)):
        for case, fn, ref in cases:
            for dtype in (torch.float32, torch.bfloat16):
                args, kw = make(case, dtype, gen)
                got = fn(*args, **kw)
                torch.cuda.synchronize()
                want = ref(*args, **kw)
                if got.shape != want.shape or got.dtype != want.dtype:
                    fail(f"{kernel} {case[0]}: {got.shape}/{got.dtype} vs "
                         f"{want.shape}/{want.dtype}")
                err = (got.float() - want.float()).abs().max().item()
                tol = TOL_F32 if dtype == torch.float32 else \
                    TOL_BF16 * want.float().abs().max().item()
                ok = err <= tol and math.isfinite(err)
                tag = f"{kernel}/{case[0]}/{str(dtype)[6:]}"
                out[tag] = {"max_abs_err": err, "tol": tol}
                print(f"[parity] {tag}: max_abs_err {err:.3e} tol {tol:.3e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    bad.append(tag)
    for case in WKV6_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"wkv6/{case[0]}/{str(dtype)[6:]}"
            out[tag] = wkv6_parity(case, dtype, gen)
            if not out[tag]["ok"]:
                bad.append(tag)
    if bad:
        fail(f"kernel parity: {bad}")
    out["wkv6/f64_oracle"] = wkv6_against_f64(WKV6_CASES[1], gen)
    out.update(grad_parity(gen))
    return out


def flash_grads(fn, args, do, kw):
    """(dq, dk, dv) of ``fn`` (flash attention or its plain version) at
    ``args`` by autograd."""
    leaves = [t.clone().requires_grad_(True) for t in args]
    return torch.autograd.grad(fn(*leaves, **kw), leaves, do)


def grad_parity(gen) -> dict:
    """K2's gradient on the card (the kernel's forward, then
    ``flash_attention_grad``) against autograd of the plain version on the
    same CUDA tensors, at GRAD_CASES, f32 and bf16."""
    out, bad = {}, []
    for case in GRAD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = flash_inputs(case, dtype, gen)
            do = randn(gen, *args[0].shape[:3], case[7], dtype=dtype)
            got = flash_grads(flash_attention, args, do, kw)
            torch.cuda.synchronize()
            want = flash_grads(flash_attention_reference, args, do, kw)
            tag = f"flash_attention_grad/{case[0]}/{str(dtype)[6:]}"
            rec = {}
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                scale = w.float().abs().max().item()
                tol = (TOL_GRAD_F32 if dtype == torch.float32 else TOL_BF16) \
                    * scale
                err = (g.float() - w.float()).abs().max().item()
                rec[name] = {"max_abs_err": err, "tol": tol,
                             "ok": g.dtype == w.dtype and err <= tol
                             and math.isfinite(err)}
            out[tag] = rec
            ok = all(r["ok"] for r in rec.values())
            print(f"[parity] {tag}: " + ", ".join(
                f"{n} {r['max_abs_err']:.3e} (tol {r['tol']:.3e})"
                for n, r in rec.items()) + f" {'ok' if ok else 'FAIL'}",
                flush=True)
            if not ok:
                bad.append(tag)
            del args, do, got, want
            torch.cuda.empty_cache()
    if bad:
        fail(f"flash attention gradient parity: {bad}")
    return out


def wkv6_against_f64(case, gen) -> dict:
    """Max abs error of K4 and of the plain version (f32) against the
    sequential recurrence in float64 on the same inputs: which of the two
    sits closer to the exact result (recorded, not checked)."""
    args, kw = wkv6_inputs(case, torch.float32, gen)
    got, got_s = wkv6(*args, **kw)
    plain, plain_s = wkv6_chunked(*args, **kw)
    r, k, v, w, u, s0 = args
    exact, exact_s = wkv6_sequential(r.double(), k.double(), v.double(),
                                     w.double().clip(1e-12, 1.0), u.double())
    errs = {name: (a.double() - b).abs().max().item() for name, a, b in (
        ("kernel_out", got, exact), ("kernel_state", got_s, exact_s),
        ("plain_out", plain, exact), ("plain_state", plain_s, exact_s))}
    print(f"[parity] wkv6/{case[0]} against float64: kernel out "
          f"{errs['kernel_out']:.3e} state {errs['kernel_state']:.3e}; plain "
          f"out {errs['plain_out']:.3e} state {errs['plain_state']:.3e}",
          flush=True)
    return errs


def wkv6_parity(case, dtype, gen) -> dict:
    """K4 against ``wkv6_chunked`` on the same CUDA tensors: out within
    TOL_F32 (f32) or TOL_BF16 x max|out| (bf16: both round out to bf16),
    the f32 final state within TOL_F32 in both (both read the same rounded
    inputs), and everything finite."""
    args, kw = wkv6_inputs(case, dtype, gen)
    got, got_s = wkv6(*args, **kw)
    torch.cuda.synchronize()
    want, want_s = wkv6_chunked(*args, **kw)
    if got.shape != want.shape or got.dtype != want.dtype \
            or got_s.shape != want_s.shape or got_s.dtype != torch.float32:
        fail(f"wkv6 {case[0]}: {got.shape}/{got.dtype}, {got_s.shape}/"
             f"{got_s.dtype} vs {want.shape}/{want.dtype}, {want_s.shape}")
    err = (got.float() - want.float()).abs().max().item()
    err_s = (got_s - want_s).abs().max().item()
    tol = TOL_F32 if dtype == torch.float32 else \
        TOL_BF16 * want.float().abs().max().item()
    finite = bool(torch.isfinite(got.float()).all() and torch.isfinite(got_s).all())
    ok = finite and err <= tol and err_s <= TOL_F32
    print(f"[parity] wkv6/{case[0]}/{str(dtype)[6:]}: max_abs_err out "
          f"{err:.3e} (tol {tol:.3e}), state {err_s:.3e} (tol {TOL_F32:.0e}), "
          f"finite {finite} {'ok' if ok else 'FAIL'}", flush=True)
    return {"max_abs_err": err, "tol": tol, "state_max_abs_err": err_s,
            "finite": finite, "ok": ok}


def timed_dtype(case) -> torch.dtype:
    return torch.bfloat16 if case[0] in BF16_TIMED else torch.float32


def phase_times() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for case in (c for c in FLASH_CASES if c[0] in FLASH_TIMED):
        dt = timed_dtype(case)
        args, kw = flash_inputs(case, dt, gen)
        lib_args = [t.transpose(1, 2).contiguous() for t in args]
        # SDPA's causal mask is aligned top left: past a prefix, a mask
        lib_kw = {"is_causal": kw["causal"]} if not kw["q_offset"] else {
            "attn_mask": attention_mask(case[2], case[3], causal=True,
                                        window=None, q_offset=kw["q_offset"],
                                        device="cuda")}
        # no PyTorch call computes a tanh softcap: library_ms null there
        library = None if kw["softcap"] else \
            (lambda: F.scaled_dot_product_attention(*lib_args, **lib_kw,
                                                    enable_gqa=True))
        out[f"flash_attention/{case[0]}"] = time_three(
            f"flash_attention/{case[0]}", lambda: flash_attention(*args, **kw),
            lambda: flash_attention_reference(*args, **kw), library,
            flash_cost(case, dt), COLD["flash_attention"], dt)
    for case in (c for c in DECODE_CASES if c[0] in DECODE_TIMED):
        dt = timed_dtype(case)
        (q, k, v, kl), kw = decode_inputs(case, dt, gen)
        mask = (torch.arange(k.shape[1], device="cuda")[None, :]
                < kl[:, None])[:, None, None, :]
        lq, lk, lv = q[:, :, None], k.transpose(1, 2).contiguous(), \
            v.transpose(1, 2).contiguous()
        library = None if kw["softcap"] else \
            (lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                                    enable_gqa=True))
        out[f"decode_attention/{case[0]}"] = time_three(
            f"decode_attention/{case[0]}", lambda: decode_attention(q, k, v, kl, **kw),
            lambda: decode_attention_reference(q, k, v, kl, **kw), library,
            decode_cost(case, dt), COLD["decode_attention"], dt)
        out[f"decode_attention/{case[0]}"]["splits"] = decode_splits(case[2])
    for case in RING_CASES:
        (q, k, v, kl), kw = decode_inputs(case, torch.float32, gen)
        # the lengths K3 reads, computed once: one launch a timed call
        ring_len = ring_lengths(kl, k.shape[1])
        out[f"decode_attention/{case[0]}"] = time_three(
            f"decode_attention/{case[0]}",
            lambda: decode_attention(q, k, v, ring_len, softcap=kw["softcap"]),
            lambda: ring_plain(q, k, v, kl, **kw), None,
            decode_cost(case, torch.float32), COLD["decode_attention"])
        out[f"decode_attention/{case[0]}"]["splits"] = decode_splits(case[2])
    for case in PAGED_CASES:
        if case[0] not in PAGED_TIMED:
            continue
        dt = timed_dtype(case)
        args, kw = paged_inputs(case, dt, gen)
        fn, ref = paged_fns(case)
        # no PyTorch call reads K/V through a block table: library_ms null
        out[f"paged_attention/{case[0]}"] = time_three(
            f"paged_attention/{case[0]}", lambda: fn(*args, **kw),
            lambda: ref(*args, **kw), None,
            paged_cost(case, dt), COLD["paged_attention"], dt)
        out[f"paged_attention/{case[0]}"]["splits"] = paged_splits(case[9], case[8])[0]
    for case in (c for c in WKV6_CASES if c[0] in WKV6_TIMED):
        args, kw = wkv6_inputs(case, torch.float32, gen)
        # no PyTorch call computes WKV6: library_ms null
        out[f"wkv6/{case[0]}"] = time_three(
            f"wkv6/{case[0]}", lambda: wkv6(*args, **kw),
            lambda: wkv6_chunked(*args, **kw), None,
            wkv6_cost(case, torch.float32), COLD["wkv6"])
    for tag, r in out.items():
        dt = "bf16, " if r["dtype"] == "bfloat16" else ""
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms (call {r['library_call_ms']:.4f})"
        cold = "" if r["cold_ms"] is None else f", cold L2 {r['cold_ms']:.4f} ms"
        print(f"[times] {tag}: {dt}kernel {r['ms']:.4f} ms (CUDA events "
              f"{r['call_ms']:.4f}"
              f"{cold}), "
              f"plain {r['plain_ms']:.4f} ms (call {r['plain_call_ms']:.4f}), "
              f"library {lib}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); device time "
              f"from torch.profiler ({r['launches_per_call']} activities a "
              "call)", flush=True)
    out["flash_attention_grad/smollm_train"] = grad_times(gen)
    return out


def grad_cost(case, dtype, forward: bool):
    """(bytes, operations) of K2's backward given q, k, v, o and dO (it
    recomputes the scores: 2 (3D + 2Dv) operations a visible pair), or with
    ``forward`` of the forward and backward together (q, k, v, dO in; o,
    dq, dk, dv out; 2 (4D + 3Dv) a pair)."""
    _, b, sq, skv, h, kv, d, dv, *_ = case
    nbytes, fwd_ops = flash_cost(case, dtype)
    size = torch.finfo(dtype).bits // 8
    pairs = fwd_ops / (2.0 * (d + dv) * b * h)
    ops = 2.0 * (3 * d + 2 * dv) * pairs * b * h
    q_rows, kv_rows = b * sq * h, b * skv * kv
    if forward:
        return 2 * nbytes, ops + fwd_ops
    return size * 2 * (q_rows + kv_rows) * (d + dv), ops


def grad_times(gen) -> dict:
    """At smollm's training shape (f32): K2's forward and gradient together
    beside the plain version's autograd and SDPA's forward and backward
    (``is_causal``, the yardstick), each against the bound of the forward
    and backward; and the gradient alone (``flash_attention_grad``)
    against its own bound."""
    case = GRAD_CASES[0]
    args, kw = flash_inputs(case, torch.float32, gen)
    do = randn(gen, *args[0].shape[:3], case[7], dtype=torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in args]
    lib = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in args]
    lib_do = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        o = flash_attention(*args, **kw)

    def both(fn, xs, g, **k):
        return lambda: torch.autograd.grad(fn(*xs, **k), xs, g)
    rec = {}
    for tag, fn in (
            ("kernel", both(flash_attention, leaves, do, **kw)),
            ("plain", both(flash_attention_reference, leaves, do, **kw)),
            ("library", both(F.scaled_dot_product_attention, lib, lib_do,
                             is_causal=True, enable_gqa=True)),
            ("grad_alone", lambda: flash_attention_grad(*args, o, do, **kw))):
        rec[tag] = timed(fn)
    b_ms, b_by = bound(*grad_cost(case, torch.float32, True), torch.float32)
    g_ms, g_by = bound(*grad_cost(case, torch.float32, False), torch.float32)
    out = {"ms": rec["kernel"]["ms"], "call_ms": rec["kernel"]["call_ms"],
           "launches_per_call": rec["kernel"]["launches_per_call"],
           "plain_ms": rec["plain"]["ms"], "library_ms": rec["library"]["ms"],
           "bound_ms": b_ms, "bound_by": b_by,
           "grad_ms": rec["grad_alone"]["ms"],
           "grad_launches": rec["grad_alone"]["launches_per_call"],
           "grad_bound_ms": g_ms, "grad_bound_by": g_by, "dtype": "float32"}
    print(f"[times] flash_attention_grad/smollm_train: forward + backward: "
          f"K2 + torch-ops gradient {out['ms']:.4f} ms (CUDA events "
          f"{out['call_ms']:.4f}, {out['launches_per_call']} device "
          f"activities), plain autograd {out['plain_ms']:.4f} ms, SDPA "
          f"{out['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); the "
          f"gradient alone {out['grad_ms']:.4f} ms ({out['grad_launches']} "
          f"activities), bound {g_ms:.4f} ms ({g_by})", flush=True)
    return out


def time_three(tag, kernel, plain, library, cost, cold: str | None = None,
               dtype=torch.float32) -> dict:
    """Kernel, plain version and library call (None: there is none) on the
    same inputs, with the bound of the function from its bytes and
    operations at ``dtype``'s peak rate.  Each wrapper launches its kernel
    once a call: the profiler must see one device activity for one call.
    ``cold``: the kernel's symbol, to time it with a cold L2 as well."""
    nbytes, ops = cost
    b_ms, b_by = bound(nbytes, ops, dtype)
    seen = len(device_kernels(kernel))
    if seen != 1:
        fail(f"{tag}: the profiler saw {seen} device activities for one "
             "kernel call")
    k, p = timed(kernel, per_call=1), timed(plain)
    k["cold_ms"] = cold_ms(kernel, cold) if cold else None
    lib = timed(library) if library is not None else {"ms": None,
                                                      "call_ms": None}
    return {**k, "plain_ms": p["ms"], "plain_call_ms": p["call_ms"],
            "plain_launches": p["launches_per_call"],
            "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops,
            "dtype": str(dtype)[6:]}


def step_breakdown(what: str, fn, reps: int = 5) -> dict:
    """Where one serving step's time goes: host-clock wall time (median of
    ``reps``, synchronised), device busy time and launches (profiler), idle
    share, and the kernels that take the most device time."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    kern = device_kernels(fn)
    busy = sum(us for _, us in kern) / 1e3
    by_name: dict = {}
    for name, us in kern:
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    rec = {"wall_ms": wall, "device_busy_ms": busy, "launches": len(kern),
           "idle_share": 1.0 - busy / wall if kern else None,
           "top_kernels_ms": {n[:60]: t for n, t in top}}
    print(f"[profile] {what}: wall {wall:.2f} ms, device busy {busy:.3f} ms, "
          f"{len(kern)} device activities, idle share "
          f"{rec['idle_share'] if kern else 'not measured'}; top "
          + "; ".join(f"{n[:40]} {t:.3f}" for n, t in top), flush=True)
    return rec


def read_launches() -> dict:
    return {"flash_attention": flash_attention.launches,
            "decode_attention": decode_attention.launches,
            "paged_attention": paged_window_attention.launches,
            "wkv6": wkv6.launches}


def reset_launches() -> None:
    flash_attention.launches = 0
    flash_attention.backward_calls = 0
    decode_attention.launches = 0
    paged_window_attention.launches = 0
    wkv6.launches = 0


def kernel_layers(cfg) -> int:
    """The layers whose mixer runs a kernel: the attention and RWKV-6 ones
    (a Mamba layer runs torch ops)."""
    return sum(sp.mixer in ("attn", "rwkv6") for sp in cfg.layer_plan())


def check_launches(what: str, prefills: int, steps: int, n_layers: int,
                   paged: bool = False, rwkv: bool = False,
                   mla: bool = False) -> dict:
    """Launches of the path just run: flash attention once per attention
    layer (``n_layers`` of them) and prefill call, the decode kernel (paged
    attention on a paged path) once per attention layer and decode or
    verify step, the other decode kernel and WKV6 never; on an MLA path no
    decode kernel (it decodes in the latent space with torch ops); on an
    rwkv path WKV6 once per layer and prefill call and no attention
    kernel."""
    got = read_launches()
    want = {"flash_attention": n_layers * prefills,
            "decode_attention": 0 if paged else n_layers * steps,
            "paged_attention": n_layers * steps if paged else 0, "wkv6": 0}
    used = ("flash_attention", "paged_attention" if paged else "decode_attention")
    if mla:
        want["decode_attention"] = 0
        used = ("flash_attention",)
    if rwkv:
        want = {k: 0 for k in want} | {"wkv6": n_layers * prefills}
        used = ("wkv6",)
    print(f"[serve] {what} launches {got} (expected {want})", flush=True)
    if got != want or min(got[k] for k in used) <= 0:
        fail(f"{what}: kernel launches {got}, expected {want}")
    return got


def logits_parity(cfg, prompts, what: str = "serve", note=None,
                  params=None) -> dict:
    """Prefill and first decode-step logits of one batch on the card vs the
    same engine on the CPU (plain kernel versions) on the same weights:
    ``params``, a phase's model on the card, cut to its first
    ``cfg.n_layers`` blocks and moved to the CPU after the card's run (the
    caller's ``params`` ends so), or without it weights drawn on the CPU
    once, a copy moved to the card; ``note``, a function called after both
    runs, adds to each printed line."""
    got = {}
    if params is None:
        params = api.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
        card = copy.deepcopy(params).to("cuda")
    else:
        params.blocks = torch.nn.ModuleList(params.blocks[:cfg.n_layers])
        card = params
    for device in ("cuda", "cpu"):
        model = card if device == "cuda" else params.to("cpu")
        eng = InferenceEngine(cfg, model, EngineConfig(max_batch=4, cache_len=64))
        toks, kv_len = eng._pad_prompts(prompts)
        lg, cache = eng._prefill(toks, kv_len)
        nxt = greedy(lg, cfg.vocab_size) if device == "cuda" else got["nxt"].cpu()
        lg2, _ = eng._decode(nxt[:, None].long(), cache, kv_len)
        got[device] = (lg.float().cpu(), lg2.float().cpu())
        got["nxt"] = nxt
        del model, eng, cache
    del card
    torch.cuda.empty_cache()
    errs = {name: (got["cuda"][i] - got["cpu"][i]).abs().max().item()
            for i, name in enumerate(("prefill", "decode"))}
    extra = note() if note is not None else ""
    for name, err in errs.items():
        print(f"[{what}] card vs CPU {name} logits: max_abs_err {err:.3e} "
              f"(tol {TOL_LOGITS}){extra}", flush=True)
        if not err <= TOL_LOGITS:
            fail(f"card vs CPU {name} logits differ by {err}")
    return errs


def check_outputs(what: str, cfg, outs: dict, n: int = 12) -> None:
    if len(outs) != n or any(not v or any(not 0 <= t < cfg.vocab_size for t in v)
                             for v in outs.values()):
        fail(f"{what}: missing outputs or token ids outside the vocab")


def agreement(outs: dict, ref: dict) -> tuple[int, int]:
    """(tokens equal position by position, tokens) of two output sets."""
    same = sum(a == b for rid in ref for a, b in zip(outs.get(rid, []), ref[rid]))
    return same, sum(len(v) for v in ref.values())


def phase_serve() -> dict:
    cfg = get_config("smollm-135m")
    reset_launches()
    t0 = time.perf_counter()
    res = serve.main(SERVE_ARGS)
    wall = time.perf_counter() - t0
    results = res["results"]
    serve_launches = check_launches("serve", len(results),
                                    sum(r.steps for r in results), cfg.n_layers)
    check_outputs("serve", cfg, res["outputs"])

    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, (4, LONG_PROMPT)).tolist()
    batch = Batch(requests=[Request(rid=i, tokens=p, input_len=len(p), slo=1e9,
                                    arrival=0.0, true_output_len=LONG_NEW)
                            for i, p in enumerate(prompts)])
    params = api.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    eng = InferenceEngine(cfg, params, EngineConfig(
        max_batch=4, cache_len=LONG_CACHE, max_new_tokens=LONG_NEW))
    true_lens = {r.rid: LONG_NEW for r in batch.requests}
    eng.run_batch(batch, true_lens=true_lens)             # warm-up
    reset_launches()
    long = eng.run_batch(batch, true_lens=true_lens)
    long_launches = check_launches("long batch", 1, long.steps, cfg.n_layers)
    long_tokens = sum(len(v) for v in long.outputs.values())
    if long_tokens != 4 * LONG_NEW:
        fail(f"long batch: {long_tokens} tokens, expected {4 * LONG_NEW}")
    print(f"[serve] long batch: prefill {long.prefill_s * 1e3:.2f} ms "
          f"({4 * LONG_PROMPT / long.prefill_s:.0f} prompt tok/s), decode "
          f"{long.steps} steps in {long.decode_s * 1e3:.2f} ms "
          f"({long_tokens / long.decode_s:.1f} tok/s)", flush=True)
    first = sorted(results[0].outputs)
    reqs = {r.rid: r for r in serve.make_requests(cfg, 12, 16)}
    first_prompts = [reqs[rid].tokens for rid in first]
    profile = {}
    for what, e, prompts in (
            ("long batch", eng, prompts),
            ("serve batch", InferenceEngine(cfg, params, EngineConfig(
                max_batch=4, cache_len=64)), first_prompts)):
        toks, kv_len = e._pad_prompts(prompts)
        profile[f"{what} prefill"] = step_breakdown(
            f"{what} prefill {tuple(toks.shape)}",
            lambda: e._prefill(toks, kv_len))
        lg, cache = e._prefill(toks, kv_len)
        nxt = greedy(lg, cfg.vocab_size)[:, None].long()
        profile[f"{what} decode step"] = step_breakdown(
            f"{what} decode step", lambda: e._decode(nxt, cache, kv_len))
    del eng, cache

    errs = logits_parity(cfg, first_prompts, params=params)
    return {"padded_outputs": res["outputs"], "first_prompts": first_prompts,
            "long_outputs": long.outputs,
            "serve": {"digest": res["digest"], "tokens": res["tokens"],
                      "seconds": res["seconds"], "wall_s": wall,
                      "tok_per_s": res["tokens"] / res["seconds"],
                      "batches": len(results),
                      "decode_steps": sum(r.steps for r in results),
                      "launches": serve_launches},
            "long_batch": {"prefill_ms": long.prefill_s * 1e3,
                           "decode_ms": long.decode_s * 1e3, "steps": long.steps,
                           "decode_tok_per_s": long_tokens / long.decode_s,
                           "launches": long_launches},
            "profile": profile, "logits_max_abs_err": errs}


def paged_logits_parity(cfg, prompts) -> dict:
    """Logits recorded from the paged engine's own path while
    ``PagedEngine.run_continuous`` serves ``prompts`` (one prefill each, then
    one paged decode step) on the card and on the CPU (plain kernel
    versions, same seeded weights): every prefill and the first decode step
    are compared."""
    pcfg = PagedEngineConfig(max_batch=len(prompts), block_size=8,
                             n_blocks=64, max_seq_len=64, max_new_tokens=2)
    prefill, decode_step = api.prefill, api.paged_decode_step
    got = {}
    for device in ("cuda", "cpu"):
        rec = {"prefill": [], "decode": None, "tokens": None}

        def rec_prefill(*a, **kw):
            lg, cache = prefill(*a, **kw)
            rec["prefill"].append(lg.float().cpu())
            return lg, cache

        def rec_decode(cfg_, params_, toks, *a, **kw):
            lg, pools = decode_step(cfg_, params_, toks, *a, **kw)
            if rec["decode"] is None:
                rec["decode"], rec["tokens"] = lg.float().cpu(), toks.cpu()
            return lg, pools

        params = api.init_params(cfg, seed=0, dtype=torch.float32, device=device)
        eng = PagedEngine(cfg, params, pcfg)
        api.prefill, api.paged_decode_step = rec_prefill, rec_decode
        try:
            eng.run_continuous([Request(rid=i, tokens=p, input_len=len(p),
                                        slo=1e9, arrival=0.0, true_output_len=2)
                                for i, p in enumerate(prompts)])
        finally:
            api.prefill, api.paged_decode_step = prefill, decode_step
        if len(rec["prefill"]) != len(prompts) or rec["decode"] is None:
            fail(f"paged engine on {device}: {len(rec['prefill'])} prefills "
                 f"and {'no' if rec['decode'] is None else 'a'} decode step "
                 f"for {len(prompts)} prompts")
        got[device] = (torch.cat(rec["prefill"]), rec["decode"], rec["tokens"])
        del params, eng
    if not torch.equal(got["cuda"][2], got["cpu"][2]):
        fail("card and CPU paged engines fed different tokens to their first "
             "decode step (a near-tied argmax flipped); logits not comparable")
    errs = {name: (got["cuda"][i] - got["cpu"][i]).abs().max().item()
            for i, name in enumerate(("prefill", "decode"))}
    for name, err in errs.items():
        print(f"[paged] card vs CPU paged {name} logits: max_abs_err "
              f"{err:.3e} (tol {TOL_LOGITS})", flush=True)
        if not err <= TOL_LOGITS:
            fail(f"card vs CPU paged {name} logits differ by {err}")
    return errs


def phase_paged(padded: dict) -> dict:
    cfg = get_config("smollm-135m")
    padded_sp = serve.main(SERVE_ARGS + ["--workload", "shared-prefix"])
    runs, launches = {}, {k: 0 for k in TIMED}
    for name, flags in PAGED_SETS.items():
        reset_launches()
        t0 = time.perf_counter()
        out = serve.main(SERVE_ARGS + flags)      # raises if the leak audit fails
        wall = time.perf_counter() - t0
        res = out["results"][0]
        got = check_launches(name, res.prefill_chunks, res.steps, cfg.n_layers,
                             paged=True)
        for k in launches:
            launches[k] += got[k]
        check_outputs(name, cfg, out["outputs"])
        ref = padded_sp["outputs"] if "shared-prefix" in flags \
            else padded["padded_outputs"]
        same, total = agreement(out["outputs"], ref)
        runs[name] = {"digest": out["digest"], "tokens": out["tokens"],
                      "seconds": out["seconds"], "wall_s": wall,
                      "tok_per_s": out["tokens"] / out["seconds"],
                      "steps": res.steps, "prefill_chunks": res.prefill_chunks,
                      "acceptance": res.acceptance_rate,
                      "prefix_hits": res.prefix_hits,
                      "prefix_lookups": res.prefix_lookups,
                      "preemptions": res.preemptions,
                      "peak_blocks": res.peak_blocks,
                      "agree_with_padded": [same, total], "launches": got}
        print(f"[paged] {name}: {out['tokens']} tokens in {out['seconds']:.2f}s "
              f"({runs[name]['tok_per_s']:.1f} tok/s), {res.steps} steps, "
              f"{res.prefill_chunks} prefill chunks, acceptance "
              f"{res.acceptance_rate:.3f}, prefix hits {res.prefix_hits}/"
              f"{res.prefix_lookups}, preemptions {res.preemptions}; leak "
              f"audit passed; {same}/{total} tokens agree with the padded path",
              flush=True)
    if runs["d_preempt"]["preemptions"] <= 0:
        fail(f"d_preempt: no preemption at a {PREEMPT_BUDGET}-byte pool")

    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, (4, LONG_PROMPT)).tolist()
    params = api.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    pcfg = PagedEngineConfig(max_batch=4, block_size=LONG_PAGE,
                             n_blocks=4 * LONG_PAGES + 1,
                             max_seq_len=LONG_PROMPT + LONG_NEW,
                             max_new_tokens=LONG_NEW)
    eng = PagedEngine(cfg, params, pcfg)

    def reqs():
        return [Request(rid=i, tokens=p, input_len=len(p), slo=1e9,
                        arrival=0.0, true_output_len=LONG_NEW)
                for i, p in enumerate(prompts)]
    eng.run_continuous(reqs())                              # warm-up
    reset_launches()
    long = eng.run_continuous(reqs())
    got = check_launches("long paged batch", long.prefill_chunks, long.steps,
                         cfg.n_layers, paged=True)
    for k in launches:
        launches[k] += got[k]
    check_outputs("long paged batch", cfg, long.outputs, n=4)
    tokens = sum(len(v) for v in long.outputs.values())
    if tokens != 4 * LONG_NEW:
        fail(f"long paged batch: {tokens} tokens, expected {4 * LONG_NEW}")
    same, total = agreement(long.outputs, padded["long_outputs"])
    print(f"[paged] long paged batch: prefill {long.prefill_s * 1e3:.2f} ms "
          f"({long.prefill_chunks} prompts, {4 * LONG_PROMPT / long.prefill_s:.0f} "
          f"prompt tok/s), decode {long.steps} steps in {long.decode_s * 1e3:.2f} ms "
          f"({tokens / long.decode_s:.1f} tok/s); {same}/{total} tokens agree "
          f"with the padded long batch", flush=True)

    # one paged decode step at the long batch's shape, K/V through permuted
    # 66-page tables at kv_len 1041
    gen = torch.Generator(device="cuda").manual_seed(2)
    pools = api.init_paged_pools(cfg, pcfg.n_blocks, LONG_PAGE, device="cuda")
    for p in pools:
        p["k"].normal_(generator=gen)
        p["v"].normal_(generator=gen)
    bt = (1 + torch.randperm(4 * LONG_PAGES, generator=gen, device="cuda")
          ).reshape(4, LONG_PAGES).to(torch.int32)
    kv_len = torch.full((4,), LONG_PROMPT + 17, dtype=torch.int32, device="cuda")
    toks = torch.randint(2, cfg.vocab_size, (4, 1), generator=gen, device="cuda")
    profile = {"long paged decode step": step_breakdown(
        "long paged decode step (4 x kv 1041, 16-token pages)",
        lambda: api.paged_decode_step(cfg, params, toks, pools, bt, kv_len))}
    del params, eng, pools
    errs = paged_logits_parity(cfg, padded["first_prompts"])
    return {"runs": runs,
            "long_paged_batch": {"prefill_ms": long.prefill_s * 1e3,
                                 "decode_ms": long.decode_s * 1e3,
                                 "steps": long.steps,
                                 "decode_tok_per_s": tokens / long.decode_s,
                                 "agree_with_padded": [same, total],
                                 "launches": got},
            "profile": profile, "logits_max_abs_err": errs,
            "launches": launches}


def count_prefills(fn):
    """(fn(), the number of ``api.prefill`` calls it made): the engines call
    the model through the ``api`` module, so a wrapper there sees each."""
    prefill, calls = api.prefill, []

    def counted(*a, **kw):
        calls.append(1)
        return prefill(*a, **kw)
    api.prefill = counted
    try:
        return fn(), len(calls)
    finally:
        api.prefill = prefill


def phase_rwkv() -> dict:
    """rwkv6-3b drawn once: served padded and continuous through
    ``serve.serve``, its long padded batch, card-vs-CPU logits at 4 of 32
    layers."""
    cfg = get_config("rwkv6-3b")
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    init_s = time.perf_counter() - t0
    print(f"[rwkv] rwkv6-3b ({cfg.n_layers} layers, d_model {cfg.d_model}) "
          f"drawn once and moved in {init_s:.1f} s", flush=True)
    # the recurrence runs over the padding, so the continuous engine's
    # re-prefilled waves need not agree with the padded batches (printed)
    runs, first, _ = serve_modes("rwkv", "rwkv", cfg, params)
    long, profile, _ = long_batch("rwkv", "rwkv", cfg, params,
                                  [LONG_PROMPT] * 4, LONG_CACHE)
    long["init_s"] = init_s
    launches = sum(r["launches"]["wkv6"] for r in runs.values()) \
        + long["launches"]["wkv6"]
    reqs = {r.rid: r for r in serve.make_requests(cfg, 12, 16)}
    print(f"[rwkv] card vs CPU logits at full width, first "
          f"{RWKV_PARITY_LAYERS} of {cfg.n_layers} layers", flush=True)
    errs = logits_parity(replace(cfg, n_layers=RWKV_PARITY_LAYERS),
                         [reqs[rid].tokens for rid in first], "rwkv",
                         params=params)
    return {"runs": runs, "long_batch": long,
            "profile": profile, "logits_layers": RWKV_PARITY_LAYERS,
            "logits_max_abs_err": errs, "launches": launches}


def serve_dense_run(what: str, cfg, fn, mode: str = "padded",
                    tag: str = "dense", n_requests: int = 12
                    ) -> tuple[dict, dict]:
    """Run one dense serve path (``fn`` returns ``serve.serve``'s or
    ``serve.main``'s dict; ``mode`` padded, continuous or paged) with the
    launch counts set to 0 just before and read just after; check its
    launches (a padded path prefills once a batch; an MLA model decodes
    without a kernel, an RWKV one runs only WKV6) and its ``n_requests``
    outputs.  Returns (its output, its record); ``tag`` heads its printed
    line."""
    reset_launches()
    t0 = time.perf_counter()
    out, prefills = count_prefills(fn)
    wall = time.perf_counter() - t0
    results = out["results"]
    steps = sum(r.steps for r in results)
    if mode == "paged":
        prefills = sum(r.prefill_chunks for r in results)
    elif mode == "padded" and prefills != len(results):
        fail(f"{what}: {prefills} prefills for {len(results)} batches")
    got = check_launches(what, prefills, steps, kernel_layers(cfg),
                         paged=mode == "paged", rwkv=cfg.rwkv is not None,
                         mla=cfg.mla is not None)
    check_outputs(what, cfg, out["outputs"], n_requests)
    rec = {"digest": out["digest"], "tokens": out["tokens"],
           "seconds": out["seconds"], "wall_s": wall,
           "tok_per_s": out["tokens"] / out["seconds"], "prefills": prefills,
           "steps": steps, "launches": got}
    print(f"[{tag}] {what}: {out['tokens']} tokens in {out['seconds']:.2f}s "
          f"({rec['tok_per_s']:.1f} tok/s), {prefills} prefills, {steps} "
          f"steps, digest {out['digest']}", flush=True)
    return out, rec


def phase_dense() -> dict:
    """qwen2-1.5b through ``serve.main`` (padded), then chatglm2-6b at full
    width and 14 of its 28 layers, drawn once and served padded,
    continuous and paged through ``serve.serve``, and its long padded
    batch; card-vs-CPU logits at 2 layers."""
    runs, launches = {}, {k: 0 for k in TIMED}

    def add(got):
        for k in launches:
            launches[k] += got[k]

    qcfg = get_config("qwen2-1.5b")
    out, runs["qwen2 padded"] = serve_dense_run(
        "qwen2 padded", qcfg,
        lambda: serve.main(["--arch", "qwen2-1.5b"] + SERVE_ARGS))
    add(runs["qwen2 padded"]["launches"])
    qfirst = sorted(out["results"][0].outputs)
    del out
    torch.cuda.empty_cache()

    cfg = replace(get_config("chatglm2-6b"), n_layers=CHATGLM2_LAYERS)
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    init_s = time.perf_counter() - t0
    plan = helr_mesh(get_config("chatglm2-6b"), SHAPES["decode_32k"]).name
    print(f"[dense] chatglm2-6b ({cfg.n_layers} of 28 layers, d_model "
          f"{cfg.d_model}, "
          f"{cfg.param_count():.4g} parameters) drawn and moved in "
          f"{init_s:.1f} s; plan for production mesh: {plan}", flush=True)
    reqs = serve.make_requests(cfg, 12, 16)
    pcfg = serve.paged_config(cfg, reqs, 16, float(PAGED_BUDGET))
    if pcfg.usable_blocks < 4 * pcfg.max_blocks:
        fail(f"chatglm2 paged: {pcfg.usable_blocks} pages at {PAGED_BUDGET} B "
             f"for 4 slots of {pcfg.max_blocks}")
    paged_obs = {"tracer": Tracer(), "cost_profiler": CostProfiler()}
    paged_obs["tracer"].add_sink(paged_obs["cost_profiler"].on_event)
    got, first, outputs = serve_modes("dense", "chatglm2", cfg, params, pcfg,
                                      paged_obs)
    runs.update(got)
    for rec in got.values():
        add(rec["launches"])
    runs["chatglm2 paged"]["obs"] = check_observed(
        "chatglm2 paged", paged_obs["tracer"], paged_obs["cost_profiler"],
        runs["chatglm2 paged"]["launches"], kernel_layers(cfg))
    overhead = trace_overhead(cfg, params, pcfg)
    cluster = cluster_live(cfg, params, outputs["paged"],
                           runs["chatglm2 paged"])
    for rec in cluster.values():
        add(rec["launches"])
    round_trip = profile_round_trip()
    for rec in round_trip["runs"].values():
        add(rec["launches"])

    long, profile, _ = long_batch("dense", "chatglm2", cfg, params,
                                  [LONG_PROMPT] * 4, LONG_CACHE)
    long["init_s"] = init_s
    add(long["launches"])

    errs = {}
    for name, c, rids, weights in (("chatglm2", cfg, first, params),
                                   ("qwen2", qcfg, qfirst, None)):
        reqs = {r.rid: r for r in serve.make_requests(c, 12, 16)}
        print(f"[dense] {name} card vs CPU logits at full width, first "
              f"{DENSE_PARITY_LAYERS} of {c.n_layers} layers", flush=True)
        errs[name] = logits_parity(replace(c, n_layers=DENSE_PARITY_LAYERS),
                                   [reqs[rid].tokens for rid in rids], "dense",
                                   params=weights)
        del weights
    del params
    return {"runs": runs, "plan": plan, "long_batch": long,
            "profile": profile, "logits_layers": DENSE_PARITY_LAYERS,
            "logits_max_abs_err": errs, "cluster": cluster,
            "profile_round_trip": round_trip, "trace_overhead": overhead,
            "launches": launches}


def trace_overhead(cfg, params, pcfg) -> dict:
    """chatglm2-6b's ``--paged`` run untraced and traced, ``OVERHEAD_CYCLES``
    cycles of one run each, the first of a cycle alternating, as the
    reference's overhead gate runs them (``benchmarks/interleave_bench.py``).
    Traced is the costliest set-up: a retaining tracer feeding a
    ``CostProfiler`` that prices every span against the replicas'
    ``LatencyModel`` with a half-life of 64.  The outputs must not change.
    The overhead is the median over cycles of traced / untraced serve
    seconds, less 1, printed beside the reference's ``PROFILE_BUDGET``
    (reported, not checked)."""
    lm = Replica(0, cfg, *paper_cluster(), max_batch=4, block_size=8).lm
    secs = {"untraced": [], "traced": []}
    digests = set()
    for i in range(OVERHEAD_CYCLES):
        for kind in sorted(secs, reverse=bool(i % 2)):
            obs = {}
            if kind == "traced":
                tracer = Tracer()
                obs = {"tracer": tracer, "cost_profiler": CostProfiler(
                    tracer=tracer, reference=lm, half_life=64)}
                tracer.add_sink(obs["cost_profiler"].on_event)
            out = serve.serve(cfg, params, serve.make_requests(cfg, 12, 16),
                              predictor(cfg.vocab_size), paged=pcfg, **obs)
            secs[kind].append(out["seconds"])
            digests.add(out["digest"])
            del out
    excess = statistics.median(t / u for t, u in zip(secs["traced"],
                                                     secs["untraced"])) - 1
    print(f"[obs] tracing overhead, chatglm2 --paged, {OVERHEAD_CYCLES} "
          f"cycles: untraced {secs['untraced']} s, traced {secs['traced']} "
          f"s; median traced / untraced - 1 = {100 * excess:+.2f}% (budget "
          f"{100 * PROFILE_BUDGET:.0f}%); digests {sorted(digests)}",
          flush=True)
    if len(digests) != 1:
        fail(f"tracing changed the outputs: digests {sorted(digests)}")
    return {"seconds": secs, "excess": excess, "budget": PROFILE_BUDGET}


def cluster_live(cfg, params, paged_outputs: dict, paged_run: dict) -> dict:
    """``serve --replicas 2 --paged`` on ``params`` (``serve.serve_cluster``:
    two live ``PagedEngine`` replicas, each with the phase's 2e7-byte pool,
    each serving its routed share in turn) for each of ``CLUSTER_LIVE``;
    each run with the launch counts set to 0 just before and read just
    after.  Checks dispatched + shed = 12, every replica's leak audit (the
    engine raises on a leak), K2 once per layer and prefill chunk and K1
    once per layer and decode step summed over the replicas, K3 and K4
    never, and prefix hits with the prefix cache on.  Prints each replica's
    share, prefill tokens, prefix hits and peak pages, the router's stats,
    tokens a second, and how many requests' outputs equal a single paged
    engine's on the same requests (``paged_outputs``, phase 8's ``--paged``
    run, for the alpaca mix; a single paged run with the same prefix cache
    and chunks, made here, for the shared-prefix mix)."""
    runs, single = {}, {"alpaca": (paged_outputs, paged_run)}
    sp = serve.make_requests(cfg, 12, 16, "shared-prefix")
    sp_pcfg = serve.paged_config(cfg, sp, 16, float(PAGED_BUDGET),
                                 prefix_cache=True, chunk_tokens=16)
    out, rec = serve_dense_run(
        "chatglm2 paged shared-prefix", cfg,
        lambda: serve.serve(cfg, params, sp,
                            predictor(cfg.vocab_size),
                            paged=sp_pcfg), "paged", "cluster")
    runs["single paged shared-prefix"] = rec
    single["shared-prefix"] = (out["outputs"], rec)
    del out
    for name, (workload, kw) in CLUSTER_LIVE.items():
        reqs = serve.make_requests(cfg, 12, 16, workload)
        observed = {}
        if name == CLUSTER_PROFILED:
            # priced against the replicas' own analytic model: chatglm2-6b
            # at this depth, HELR-deployed on the paper's cluster (the CLI
            # attaches no reference, so its profiles carry no ratios)
            tracer = Tracer()
            observed = {"tracer": tracer, "cost_profiler": CostProfiler(
                reference=Replica(0, cfg, *paper_cluster(), max_batch=4,
                                  block_size=8).lm, tracer=tracer)}
            tracer.add_sink(observed["cost_profiler"].on_event)
        out, rec = serve_dense_run(
            f"cluster {name}", cfg,
            lambda: serve.serve_cluster(
                cfg, params, reqs, predictor(cfg.vocab_size),
                replicas=2, kv_budget=float(PAGED_BUDGET), **kw, **observed),
            "paged", "cluster")
        served = [rep for rep in out["replicas"] if rep.queue]
        res = out["results"]
        router = out["router"]
        if router["dispatched"] + router["shed"] != 12:
            fail(f"cluster {name}: router {router} does not account for 12")
        if kw.get("prefix_cache") and sum(r.prefix_hits for r in res) <= 0:
            fail(f"cluster {name}: no prefix hits with the prefix cache on")
        ref, ref_run = single[workload]
        same_req = sum(out["outputs"].get(rid) == toks
                       for rid, toks in ref.items())
        same, total = agreement(out["outputs"], ref)
        reps = [{"rid": rep.rid, "requests": len(rep.queue),
                 "prefill_tokens": r.prefill_tokens,
                 "prefix_hits": [r.prefix_hits, r.prefix_lookups],
                 "peak_blocks": r.peak_blocks, "steps": r.steps,
                 "prefill_chunks": r.prefill_chunks}
                for rep, r in zip(served, res)]
        runs[name] = rec | {
            "single_tok_per_s": ref_run["tok_per_s"],
            "single_steps": ref_run["steps"], "replicas": reps,
            "router": router,
            "requests_agree_with_single": [same_req, len(ref)],
            "tokens_agree_with_single": [same, total]}
        for r in reps:
            print(f"[cluster] {name}: replica {r['rid']}: {r['requests']} "
                  f"requests, prefill_tokens={r['prefill_tokens']}, "
                  f"prefix_hits={r['prefix_hits'][0]}/{r['prefix_hits'][1]}, "
                  f"peak_blocks={r['peak_blocks']}, {r['steps']} steps; leak "
                  f"audit passed", flush=True)
        print(f"[cluster] {name}: router {router}; {rec['tok_per_s']:.1f} "
              f"tok/s (single paged engine {ref_run['tok_per_s']:.1f}), "
              f"{rec['steps']} decode steps summed (single "
              f"{ref_run['steps']}); "
              f"{same_req}/{len(ref)} requests ({same}/{total} tokens) agree "
              f"with the single paged engine", flush=True)
        del out
        if observed:
            profile = str(OBS_DIR / f"cluster_{name}_profile.json")
            runs[name]["obs"] = check_observed(
                f"cluster {name}", tracer, observed["cost_profiler"],
                rec["launches"], kernel_layers(cfg), profile_out=profile)
            runs[name]["cells"] = cell_report(f"cluster {name}",
                                              observed["cost_profiler"])
            runs[f"{name} --profile-in"] = cluster_profile_in(
                cfg, params, name, workload, kw, profile)
    return runs


def check_observed(what: str, tracer, cprof, launches: dict, n_layers: int,
                   **paths) -> dict:
    """Writes a traced run's Chrome trace and metrics JSON under
    ``OBS_DIR`` through ``serve.write_artifacts`` (``paths``: its other
    outputs, ``profile_out``), and checks that both validate, that the
    events pass ``check_invariants``, and that the run's distinct decode
    iterations (one span a slot, the slots of one iteration sharing its
    interval) and its ``prefill_chunk`` spans, times ``n_layers``, equal
    its paged and flash attention launches."""
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    tag = what.replace(" ", "_")
    art = serve.write_artifacts(
        cprof.monitor, tracer, cprof,
        trace=str(OBS_DIR / f"{tag}_trace.json"),
        metrics_json=str(OBS_DIR / f"{tag}_metrics.json"), **paths)
    errs = (validate_trace(art["trace"]) + check_invariants(tracer.events)
            + validate_metrics(art["metrics"]))
    spans = [e for e in tracer.events if e.ph == "X"]
    iters = len({(e.track, e.t0, e.dur) for e in spans
                 if e.name in ("decode", "verify")})
    chunks = sum(e.name == "prefill_chunk" for e in spans)
    rec = {"events": len(tracer.events), "errors": errs,
           "decode_iterations": iters, "prefill_chunks": chunks,
           "profile_cells": len(cprof.cells),
           "drift_events": cprof.drift_events}
    print(f"[obs] {what}: {len(tracer.events)} events, trace, invariants "
          f"and metrics {len(errs)} errors; {iters} decode iterations x "
          f"{n_layers} layers = {iters * n_layers} (paged attention "
          f"launches {launches['paged_attention']}), {chunks} prefill "
          f"chunks x {n_layers} = {chunks * n_layers} (flash attention "
          f"launches {launches['flash_attention']}); profile "
          f"{len(cprof.cells)} cells, {cprof.drift_events} drift events",
          flush=True)
    if errs:
        fail(f"{what}: trace or metrics invalid: {errs[:5]}")
    if iters * n_layers != launches["paged_attention"] \
            or chunks * n_layers != launches["flash_attention"]:
        fail(f"{what}: the trace's spans do not match the kernel launches")
    return rec


def cell_report(what: str, cprof) -> list:
    """Each decode and prefill cell of a run's cost profile, priced against
    a ``LatencyModel`` (its ``reference``): the samples' mean measured
    seconds, the mean of their measured / model ratios (``ratio_ema``,
    undecayed), and the model's mean implied by the two (exact where the
    model prices a cell's samples alike, as it does here to 0.03%)."""
    rows = []
    for key in sorted(cprof.cells):
        cell = cprof.cells[key]
        if key[0] not in ("decode", "prefill") or not cell.ratio_count:
            continue
        rows.append({"key": list(key), "samples": cell.count,
                     "measured_ms": 1e3 * cell.mean_s,
                     "latency_model_ms": 1e3 * cell.mean_s / cell.ratio_ema,
                     "ratio": cell.ratio_ema})
        print(f"[obs] {what} cell {key}: {cell.count} samples, measured "
              f"{1e3 * cell.mean_s:.6g} ms, LatencyModel "
              f"{1e3 * cell.mean_s / cell.ratio_ema:.6g} ms, ratio "
              f"{cell.ratio_ema:.6g}", flush=True)
    if not rows:
        fail(f"{what}: no decode or prefill cell was priced")
    return rows


def cluster_profile_in(cfg, params, name: str, workload: str, kw: dict,
                       profile: str) -> dict:
    """Live cluster run ``name`` again, as ``serve --profile-in PROFILE
    --pricing-quantile 0.95`` runs it: the saved registry calibrates each
    replica's mean and tail pricing models, the profiler learns on through
    a tracer that keeps nothing; prints ``write_artifacts``'s calibration
    and drift lines and checks that pricing covered some projections."""
    tracer = Tracer(retain=False)
    cprof = CostProfiler.load(profile, tracer=tracer)
    tracer.add_sink(cprof.on_event)
    reqs = serve.make_requests(cfg, 12, 16, workload)
    out, rec = serve_dense_run(
        f"cluster {name} --profile-in", cfg,
        lambda: serve.serve_cluster(
            cfg, params, reqs, predictor(cfg.vocab_size),
            replicas=2, kv_budget=float(PAGED_BUDGET), tracer=tracer,
            cost_profiler=cprof, calibrated=True,
            pricing_quantile=PRICING_QUANTILE, **kw),
        "paged", "cluster")
    serve.write_artifacts(cprof.monitor, tracer, cprof, profile_in=profile,
                          cal_models=out["cal_models"])
    pricing = serve.pricing_counters(out["cal_models"])
    rec |= {"pricing": pricing, "cal_models": len(out["cal_models"]),
            "drift_events": cprof.drift_events}
    print(f"[obs] cluster {name} --profile-in: {len(out['cal_models'])} "
          f"calibrated models, pricing {pricing}", flush=True)
    if pricing["covered_frac"] <= 0:
        fail(f"cluster {name} --profile-in: calibrated pricing covered "
             f"nothing: {pricing}")
    return rec


def profile_round_trip() -> dict:
    """``ci.sh``'s profile smoke on the card: ``serve --paged --speculate
    --chunk-tokens 8 --requests 8`` (the reduced smollm-135m) with
    ``--profile-out``, then with ``--profile-in`` that registry, each with
    its launches checked; both outputs digests must be equal, and equal to
    the same argv's on the CPU (the kernels' plain versions)."""
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    cfg = get_config("smollm-135m").reduced()
    profile = str(OBS_DIR / "round_trip_profile.json")
    runs = {}
    for flag in ("--profile-out", "--profile-in"):
        _, runs[flag] = serve_dense_run(
            f"smollm reduced {flag}", cfg,
            lambda: serve.main(PROFILE_ROUND_TRIP
                               + ["--device", "cuda", flag, profile]),
            "paged", "obs", n_requests=8)
    cpu = serve.main(PROFILE_ROUND_TRIP + ["--device", "cpu"])["digest"]
    digests = [rec["digest"] for rec in runs.values()]
    print(f"[obs] profile round trip: outputs digests {digests} on the card, "
          f"{cpu} on the CPU", flush=True)
    if digests != [cpu, cpu]:
        fail(f"profile round trip: the digests differ: {digests}, CPU {cpu}")
    return {"runs": runs, "cpu_digest": cpu}


def phase_cluster(dense: dict) -> dict:
    """``serve --arch chatglm2-6b --replicas 4`` on the simulated cluster
    (``CLUSTER_SIM``): host code but for the length predictor, which runs
    on the card; no weights are drawn and no kernel may launch.  Checks
    finished + shed = offered and that the monitor observed every offered
    request; then ``cli_profile_in`` beside phase 8's (``dense``)
    calibrated rerun."""
    runs = {}
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    paths = {k: str(OBS_DIR / f"sim_slo_aware_{k}.json")
             for k in ("trace", "metrics", "profile")}
    for name, flags in CLUSTER_SIM.items():
        if name == "slo_aware":
            flags = flags + ["--trace", paths["trace"], "--metrics-json",
                             paths["metrics"], "--profile-out",
                             paths["profile"]]
        reset_launches()
        t0 = time.perf_counter()
        out = serve.main(["--arch", "chatglm2-6b", "--replicas", "4",
                          "--device", "cuda"] + flags)
        wall = time.perf_counter() - t0
        got = read_launches()
        s = out["cluster"].summary()
        observed = out["monitor"].stats.slo_observed
        print(f"[cluster] sim {name} ({' '.join(flags)}): {wall:.2f} s; "
              f"offered {s['offered']}, finished {s['finished']}, shed "
              f"{s['shed']}, slo_attainment {s['slo_attainment']}, monitor "
              f"slo_observed {observed}, peak_replicas "
              f"{s['peak_replicas']}, scale_events {s['scale_events']}",
              flush=True)
        if s["finished"] + s["shed"] != s["offered"]:
            fail(f"cluster sim {name}: finished + shed != offered: {s}")
        if observed != s["offered"]:
            fail(f"cluster sim {name}: the monitor observed {observed} of "
                 f"{s['offered']}")
        if any(got.values()):
            fail(f"cluster sim {name}: kernels launched {got}")
        runs[name] = {"summary": s, "slo_observed": observed, "wall_s": wall}
        if name == "slo_aware":
            runs[name]["obs"] = check_sim_artifacts(out, paths)
    runs["slo_aware --profile-in"] = cli_profile_in(
        paths["profile"], runs["slo_aware"]["summary"],
        dense["cluster"][f"{CLUSTER_PROFILED} --profile-in"]["pricing"])
    return {"runs": runs}


def cli_profile_in(profile: str, summary: dict, harness: dict) -> dict:
    """The slo_aware run again with its own saved profile as
    ``--profile-in`` at ``--pricing-quantile 0.95``: the CLI attaches no
    reference model, so its profiles carry no measured / model ratios and
    every projection falls back to the analytic model (covered_frac 0),
    which the run's summary, equal to the uncalibrated run's, must show.
    Printed beside ``harness``, the pricing of phase 8's rerun on a profile
    that the harness priced against the ``LatencyModel``."""
    flags = CLUSTER_SIM["slo_aware"] + ["--profile-in", profile,
                                        "--pricing-quantile",
                                        str(PRICING_QUANTILE)]
    reset_launches()
    out = serve.main(["--arch", "chatglm2-6b", "--replicas", "4",
                      "--device", "cuda"] + flags)
    got = read_launches()
    pricing = serve.pricing_counters(out["cal_models"])
    same = out["cluster"].summary() == summary
    print(f"[obs] sim slo_aware --profile-in its own profile "
          f"(--pricing-quantile {PRICING_QUANTILE}): pricing {pricing}, "
          f"summary equal to the uncalibrated run's: {same}; the live "
          f"cluster's calibrated rerun (a profile priced against the "
          f"LatencyModel): covered_frac {harness['covered_frac']}",
          flush=True)
    if not same or any(got.values()):
        fail(f"sim slo_aware --profile-in: summary equal {same}, kernels "
             f"launched {got}")
    return {"pricing": pricing, "summary_equal": same,
            "harness_pricing": harness}


def check_sim_artifacts(out: dict, paths: dict) -> dict:
    """The simulated run's trace, metrics JSON and saved profile: each
    must validate (the profile by loading to the same registry, with
    decode and prefill samples), and its events pass ``check_invariants``."""
    with open(paths["trace"]) as f, open(paths["metrics"]) as g:
        trace, metrics = json.load(f), json.load(g)
    prof = CostProfiler.load(paths["profile"])
    cov = prof.coverage()
    errs = (validate_trace(trace) + validate_metrics(metrics)
            + check_invariants(out["tracer"].events))
    if prof.to_json() != out["cost_profiler"].to_json():
        errs.append("the saved profile does not load to the run's")
    rec = {"events": len(trace["traceEvents"]), "errors": errs,
           "coverage": cov}
    print(f"[obs] sim slo_aware: {len(trace['traceEvents'])} trace events, "
          f"profile coverage {cov}, {len(errs)} errors", flush=True)
    if errs or not all(cov.get(p, {}).get("samples") for p in
                       ("decode", "prefill")):
        fail(f"sim slo_aware: artifacts invalid: {errs[:5]} {cov}")
    return rec


def long_batch(tag: str, name: str, cfg, params, lengths, cache_len: int):
    """One long padded batch (seeded prompts of ``lengths`` tokens, LONG_NEW
    new ones; after a warm-up run) with the launch counts set to 0 just
    before and read just after, then ``[profile]`` lines of its prefill and
    of one decode step.
    Returns (record, profile, the width of each layer's cache)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in lengths]
    batch = Batch(requests=[Request(rid=i, tokens=p, input_len=len(p), slo=1e9,
                                    arrival=0.0, true_output_len=LONG_NEW)
                            for i, p in enumerate(prompts)])
    true_lens = {r.rid: LONG_NEW for r in batch.requests}
    eng = InferenceEngine(cfg, params, EngineConfig(
        max_batch=len(prompts), cache_len=cache_len, max_new_tokens=LONG_NEW))
    eng.run_batch(batch, true_lens=true_lens)
    reset_launches()
    long = eng.run_batch(batch, true_lens=true_lens)
    got = check_launches(f"{name} long batch", 1, long.steps,
                         kernel_layers(cfg),
                         rwkv=cfg.rwkv is not None, mla=cfg.mla is not None)
    check_outputs(f"{name} long batch", cfg, long.outputs, n=len(prompts))
    tokens = sum(len(v) for v in long.outputs.values())
    if tokens != len(prompts) * LONG_NEW:
        fail(f"{name} long batch: {tokens} tokens, expected "
             f"{len(prompts) * LONG_NEW}")
    n_prompt = sum(lengths)
    print(f"[{tag}] {name} long batch {list(lengths)}: prefill "
          f"{long.prefill_s * 1e3:.2f} ms ({n_prompt / long.prefill_s:.0f} "
          f"prompt tok/s), decode {long.steps} steps in "
          f"{long.decode_s * 1e3:.2f} ms ({tokens / long.decode_s:.1f} tok/s); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          "GiB", flush=True)
    toks, kv_len = eng._pad_prompts(prompts)
    profile = {f"{name} long prefill": step_breakdown(
        f"{name} long prefill {tuple(toks.shape)}",
        lambda: eng._prefill(toks, kv_len))}
    lg, cache = eng._prefill(toks, kv_len)
    widths = [next(iter(c.values())).shape[1] for c in cache]
    nxt = greedy(lg, cfg.vocab_size)[:, None].long()
    profile[f"{name} long decode step"] = step_breakdown(
        f"{name} long decode step", lambda: eng._decode(nxt, cache, kv_len))
    del eng, cache, lg
    rec = {"prompt_lengths": list(lengths), "cache_len": cache_len,
           "prefill_ms": long.prefill_s * 1e3, "decode_ms": long.decode_s * 1e3,
           "steps": long.steps, "decode_tok_per_s": tokens / long.decode_s,
           "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": got}
    return rec, profile, widths


def serve_modes(tag: str, name: str, cfg, params,
                paged: PagedEngineConfig | None = None,
                paged_obs: dict | None = None) -> tuple[dict, list, dict]:
    """``serve.serve`` padded, ``--continuous`` and, given a ``paged`` pool,
    ``--paged`` on ``params`` (with ``paged_obs``'s tracer and cost
    profiler, where given), each with fresh requests and a freshly
    fitted predictor's copy (``predictor``); how many tokens each
    later mode shares with the padded one is printed (RWKV-6's recurrence
    over the padding and MoE capacity over the padded batch can make a
    prompt's output depend on its batch).  Returns (the runs' records, the
    first padded batch's rids, each mode's outputs)."""
    runs, outputs = {}, {}
    modes = [("padded", {}), ("continuous", {"continuous": True})]
    if paged is not None:
        modes.append(("paged", {"paged": paged} | (paged_obs or {})))
    for mode, kw in modes:
        out, runs[f"{name} {mode}"] = serve_dense_run(
            f"{name} {mode}", cfg,
            lambda: serve.serve(cfg, params, serve.make_requests(cfg, 12, 16),
                                predictor(cfg.vocab_size), **kw),
            mode, tag)
        outputs[mode] = out["outputs"]
        if mode == "padded":
            first = sorted(out["results"][0].outputs)
        del out
    for mode, _ in modes[1:]:
        same, total = agreement(outputs[mode], outputs["padded"])
        runs[f"{name} {mode}"]["agree_with_padded"] = [same, total]
        print(f"[{tag}] {name} {mode} vs padded: {same}/{total} tokens agree",
              flush=True)
    return runs, first, outputs


def phase_window_mla() -> dict:
    """gemma2-27b at full width and 6 of its 46 layers, drawn once:
    served padded and continuous (cache_len 64, so every local layer keeps
    a ring of 64), then a long padded batch whose prompts pass the 4,096
    window (the local layers' rings wrap), card-vs-CPU logits at 2 layers
    (one local, one global); then minicpm3-4b at full width and 31 of its
    62 layers, the same serve paths, a 4 x 1024 batch, and card-vs-CPU
    logits at 2 layers."""
    launches = {k: 0 for k in TIMED}
    runs, long, profile, errs = {}, {}, {}, {}

    def add(got):
        for k in launches:
            launches[k] += got[k]

    torch.cuda.empty_cache()
    full = get_config("gemma2-27b")
    # the depth cut ``serve.main`` makes on this card, checked on the host;
    # the phase runs 6 of its local/global pairs
    kept = serve.fit_depth(full, serve.card_weight_bytes("cuda"))
    if kept.n_layers < GEMMA2_LAYERS or GEMMA2_LAYERS % group_period(full):
        fail(f"gemma2-27b: fit_depth keeps {kept.n_layers} layers; the phase "
             f"runs {GEMMA2_LAYERS}")
    cfg = replace(full, n_layers=GEMMA2_LAYERS)
    gemma2_layers = cfg.n_layers
    nbytes = 4 * cfg.param_count()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, dtype=torch.float32, device="cuda",
                             generator_device="cuda")
    init_s = {"gemma2": time.perf_counter() - t0}
    plan = {"gemma2": helr_mesh(full, SHAPES["decode_32k"]).name}
    print(f"[window] gemma2-27b at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} of {cfg.head_dim_eff}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, window "
          f"{cfg.sliding_window}), depth cut {full.n_layers} -> "
          f"{cfg.n_layers} layers (fit_depth keeps {kept.n_layers} on this "
          f"card): {cfg.param_count():.4g} "
          f"parameters, {nbytes / 1e9:.2f} GB of f32 weights (all "
          f"{full.n_layers}: {4 * full.param_count() / 1e9:.1f} GB), drawn "
          f"and moved in {init_s['gemma2']:.1f} s; plan for production mesh: "
          f"{plan['gemma2']}", flush=True)
    got, first, _ = serve_modes("window", "gemma2", cfg, params)
    runs.update(got)
    long["gemma2"], prof, widths = long_batch(
        "window", "gemma2", cfg, params, GEMMA2_LONG, GEMMA2_CACHE)
    profile.update(prof)
    want = [GEMMA2_WINDOW if s.attn == "window" else GEMMA2_CACHE
            for s in cfg.layer_plan()]
    print(f"[window] gemma2 long batch cache widths: local {widths[0]}, "
          f"global {widths[1]} (expected {want[:2]})", flush=True)
    if widths != want:
        fail(f"gemma2 long batch: cache widths {widths}, expected {want}")
    for rec in list(got.values()) + [long["gemma2"]]:
        add(rec["launches"])
    reqs = {r.rid: r for r in serve.make_requests(cfg, 12, 16)}
    print(f"[window] gemma2 card vs CPU logits at full width, first "
          f"{WINDOW_PARITY_LAYERS} of {cfg.n_layers} layers (one local, one "
          "global)", flush=True)
    errs["gemma2"] = logits_parity(
        replace(full, n_layers=WINDOW_PARITY_LAYERS),
        [reqs[rid].tokens for rid in first], "window", params=params)
    del params

    cfg = replace(get_config("minicpm3-4b"), n_layers=MINICPM3_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, dtype=torch.float32, device="cuda",
                             generator_device="cuda")
    init_s["minicpm3"] = time.perf_counter() - t0
    plan["minicpm3"] = helr_mesh(get_config("minicpm3-4b"),
                                 SHAPES["decode_32k"]).name
    print(f"[mla] minicpm3-4b at full width ({cfg.n_layers} of 62 layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads, latent "
          f"{cfg.mla.kv_lora_rank} + rope {cfg.mla.qk_rope_head_dim}, D "
          f"{cfg.head_dim_eff}, Dv {cfg.v_head_dim_eff}): "
          f"{cfg.param_count():.4g} parameters, "
          f"{4 * cfg.param_count() / 1e9:.2f} GB of f32 weights, drawn and "
          f"moved in {init_s['minicpm3']:.1f} s; plan for production mesh: "
          f"{plan['minicpm3']}", flush=True)
    got, first, _ = serve_modes("mla", "minicpm3", cfg, params)
    runs.update(got)
    long["minicpm3"], prof, _ = long_batch(
        "mla", "minicpm3", cfg, params, [LONG_PROMPT] * 4, LONG_CACHE)
    profile.update(prof)
    for rec in list(got.values()) + [long["minicpm3"]]:
        add(rec["launches"])
    reqs = {r.rid: r for r in serve.make_requests(cfg, 12, 16)}
    print(f"[mla] minicpm3 card vs CPU logits at full width, first "
          f"{DENSE_PARITY_LAYERS} of {cfg.n_layers} layers", flush=True)
    errs["minicpm3"] = logits_parity(
        replace(cfg, n_layers=DENSE_PARITY_LAYERS),
        [reqs[rid].tokens for rid in first], "mla", params=params)
    return {"runs": runs, "plan": plan, "init_s": init_s,
            "gemma2_layers": gemma2_layers, "gemma2_fit_depth": kept.n_layers,
            "gemma2_weight_bytes": nbytes, "long_batch": long,
            "profile": profile, "logits_max_abs_err": errs,
            "launches": launches}


@contextlib.contextmanager
def moe_watch(margins: bool = False):
    """While the block runs, ``moe.moe_apply`` (the stack calls it through
    its module) also keeps each prefill call's (S > 1) drop fraction, a
    device tensor read only at the end, and with ``margins`` each call's
    smallest router top-k margin (``moe.router_margin``)."""
    apply, seen = moe.moe_apply, {"drop_frac": [], "margin": []}

    def watched(cfg, p, x, **kw):
        y, aux = apply(cfg, p, x, **kw)
        if x.shape[1] > 1:
            seen["drop_frac"].append(aux["drop_frac"])
        if margins:
            seen["margin"].append(moe.router_margin(cfg, p, x))
        return y, aux
    moe.moe_apply = watched
    try:
        yield seen
    finally:
        moe.moe_apply = apply


def expert_gemms(cfg, p, tokens: int) -> dict:
    """Device time of one MoE layer's three batched expert products at the
    capacity of a call over ``tokens`` tokens ([E, C, d] x [E, d, f] twice,
    [E, C, f] x [E, f, d]) on layer ``p``'s banks, mean of 5, and the
    kernels that run them (in the banks' dtype)."""
    c = moe.expert_capacity(cfg, tokens)
    gen = torch.Generator(device="cuda").manual_seed(3)
    e, d, f = p.up.shape
    buf = torch.randn(e, c, d, generator=gen, device="cuda").to(p.up.dtype)
    hid = torch.randn(e, c, f, generator=gen, device="cuda").to(p.up.dtype)

    def run():
        torch.matmul(buf, p.up)
        torch.matmul(buf, p.gate)
        torch.matmul(hid, p.down)
    kern = device_kernels(run, 5)
    return {"tokens": tokens, "capacity": c,
            "ms": sum(us for _, us in kern) / 5 / 1e3,
            "kernels": sorted({name[:60] for name, _ in kern})}


def moe_syncs(cfg, p, tokens: int) -> int:
    """Host waits for the card inside one ``moe.moe_apply`` over ``tokens``
    tokens on the MoE layer ``p`` (after a warm-up call): the synchronizing
    CUDA calls PyTorch warns of in its sync-debug mode (a prototype, which
    says it does not yet see every such call)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(1, tokens, cfg.d_model, generator=gen,
                    device="cuda").to(p.up.dtype)
    moe.moe_apply(cfg, p, x)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            moe.moe_apply(cfg, p, x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def moe_report(name: str, cfg, params, seen, step: dict) -> dict:
    """``[moe]`` lines of a served MoE model: the largest fraction of (token,
    expert) entries its capacity dropped at a prefill (``moe_watch``'s
    record ``seen``), the expert GEMMs' device time at the long prefill's
    and a decode step's token counts on its first MoE layer's banks, and
    the bytes of weights a decode step reads against the long decode
    step's profile ``step``."""
    rec = {}
    drops = torch.stack(seen["drop_frac"]).float().cpu()
    rec["max_prefill_drop_frac"] = drops.max().item()
    rec["prefill_calls"] = len(drops)
    print(f"[moe] {name}: largest fraction of (token, expert) entries "
          f"dropped past capacity at a prefill: {drops.max().item():.4f} "
          f"(mean {drops.mean().item():.4f} over {len(drops)} MoE layer "
          "calls at prefill)", flush=True)
    specs = cfg.layer_plan()
    n_moe = sum(sp.mlp == "moe" for sp in specs)
    p = next(b.mlp for b, sp in zip(params.blocks, specs) if sp.mlp == "moe")
    for what, tokens in (("long prefill", 4 * LONG_PROMPT), ("decode step", 4)):
        rec[f"expert_gemms {what}"] = g = expert_gemms(cfg, p, tokens)
        g["host_syncs"] = moe_syncs(cfg, p, tokens)
        print(f"[moe] {name}: expert GEMMs at the {what} (T = {tokens}, "
              f"capacity {g['capacity']}): {g['ms']:.3f} ms of device time "
              f"a layer, x {n_moe} = {g['ms'] * n_moe:.2f} ms; kernels "
              f"{g['kernels']}; host waits inside one MoE call "
              f"{g['host_syncs']}", flush=True)
        if g["host_syncs"]:
            fail(f"{name}: the MoE dispatch waits for the card "
                 f"{g['host_syncs']} times at T = {tokens}")
    # a decode step reads every weight but the embedding table (its 4 rows
    # aside), the routers included
    size = params.embed.w.element_size()
    nbytes = size * (cfg.param_count() - cfg.padded_vocab * cfg.d_model
                     + n_moe * cfg.d_model * cfg.moe.n_experts)
    rec["decode_weight_bytes"] = nbytes
    rec["decode_bound_ms"] = nbytes / H100.hbm_bw * 1e3
    print(f"[moe] {name}: a decode step reads {nbytes / 1e9:.2f} GB of "
          f"{str(params.embed.w.dtype)[6:]} weights (every expert bank): at "
          f"least {rec['decode_bound_ms']:.2f} ms at "
          f"{H100.hbm_bw / 1e12:.2f} TB/s; the long decode step took "
          f"{step['device_busy_ms']:.2f} ms of device time "
          f"({step['wall_ms']:.2f} wall)", flush=True)
    return rec


def phase_moe_vlm() -> dict:
    """qwen2-moe-a2.7b at full width and 6 of its 24 layers, then
    qwen2-vl-7b at full width and 14 of its 28 (``serve.fit_depth`` must
    keep every layer of both), drawn once: served padded,
    continuous and paged, a 4 x 1024 padded batch, card-vs-CPU logits at 2
    layers; for qwen2-moe the largest drop fraction at a prefill, the
    expert GEMMs' device time, the weight bytes a decode step reads against
    its device time, and the router margin beside the logits."""
    launches = {k: 0 for k in TIMED}
    runs, long, profile, errs, init_s, plan, moe_rec = {}, {}, {}, {}, {}, {}, {}

    def add(got):
        for k in launches:
            launches[k] += got[k]

    for tag, name, arch in (("moe", "qwen2-moe", "qwen2-moe-a2.7b"),
                            ("vlm", "qwen2-vl", "qwen2-vl-7b")):
        torch.cuda.empty_cache()
        full = get_config(arch)
        kept = serve.fit_depth(full, serve.card_weight_bytes("cuda"))
        if kept is not full:
            fail(f"{arch}: fit_depth cut it to {kept.n_layers} of "
                 f"{full.n_layers} layers; the card should hold it whole")
        cfg = replace(full, n_layers=QWEN2_MOE_LAYERS if full.moe
                      else QWEN2_VL_LAYERS)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = api.init_params(cfg, seed=0, dtype=torch.float32, device="cuda",
                                 generator_device="cuda")
        init_s[name] = time.perf_counter() - t0
        plan[name] = helr_mesh(full, SHAPES["decode_32k"]).name
        experts = "" if cfg.moe is None else (
            f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} and "
            f"{cfg.moe.n_shared_experts} shared of {cfg.moe.d_expert}")
        print(f"[{tag}] {arch} at full width, {cfg.n_layers} of "
              f"{full.n_layers} layers (fit_depth keeps all {kept.n_layers}; "
              f"d_model {cfg.d_model}, {cfg.n_heads} heads over "
              f"{cfg.n_kv_heads} of {cfg.head_dim_eff}{experts}, rope "
              f"{cfg.rope}): {cfg.param_count():.4g} parameters, "
              f"{4 * cfg.param_count() / 1e9:.2f} GB of f32 weights, drawn once "
              f"and moved in {init_s[name]:.1f} s; plan for production mesh: "
              f"{plan[name]}", flush=True)
        pcfg = serve.paged_config(cfg, serve.make_requests(cfg, 12, 16), 16,
                                  float(MOE_VLM_BUDGET))
        if pcfg.usable_blocks < 4 * pcfg.max_blocks:
            fail(f"{name} paged: {pcfg.usable_blocks} pages at "
                 f"{MOE_VLM_BUDGET} B for 4 slots of {pcfg.max_blocks}")
        with moe_watch() as seen:
            got, first, _ = serve_modes(tag, name, cfg, params, pcfg)
            long[name], prof, _ = long_batch(tag, name, cfg, params,
                                             [LONG_PROMPT] * 4, LONG_CACHE)
        runs.update(got)
        profile.update(prof)
        for rec in list(got.values()) + [long[name]]:
            add(rec["launches"])
        if cfg.moe is not None:
            moe_rec = moe_report(name, cfg, params, seen,
                                 profile[f"{name} long decode step"])
        reqs = {r.rid: r for r in serve.make_requests(cfg, 12, 16)}
        print(f"[{tag}] {name} card vs CPU logits at full width, first "
              f"{DENSE_PARITY_LAYERS} of {cfg.n_layers} layers", flush=True)
        with moe_watch(margins=cfg.moe is not None) as seen:
            errs[name] = logits_parity(
                replace(cfg, n_layers=DENSE_PARITY_LAYERS),
                [reqs[rid].tokens for rid in first], tag, params=params,
                note=None if cfg.moe is None else lambda: (
                    f"; smallest router top-k margin of its MoE inputs "
                    f"{min(seen['margin']):.3e}"))
        if cfg.moe is not None:
            moe_rec["logits_min_router_margin"] = min(seen["margin"])
        del params
    return {"runs": runs, "plan": plan, "init_s": init_s, "long_batch": long,
            "profile": profile, "logits_max_abs_err": errs, "moe": moe_rec,
            "qwen2_moe_layers": QWEN2_MOE_LAYERS, "launches": launches}


def encdec_prompts(cfg, lengths, rng) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded decoder prompts of ``lengths`` tokens, right-padded: (the rows
    [B, max] and the lengths [B] int32, on the card)."""
    toks = torch.zeros((len(lengths), max(lengths)), dtype=torch.long)
    for i, n in enumerate(lengths):
        toks[i, :n] = torch.from_numpy(rng.integers(2, cfg.vocab_size, n))
    return toks.cuda(), torch.tensor(lengths, dtype=torch.int32, device="cuda")


def whisper_inputs(cfg) -> tuple:
    """Phases 11 and 20's seeded inputs on the card: the frames [4, 1,536,
    d] x 0.02 and, for each of WHISPER_BATCHES, (its right-padded prompts,
    their lengths, its new tokens, its cache_len)."""
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(
        (rng.standard_normal((4, WHISPER_FRAMES, cfg.d_model)) * 0.02
         ).astype(np.float32)).cuda()
    return frames, {what: (*encdec_prompts(cfg, lengths, rng), n_new,
                           cache_len)
                    for what, lengths, n_new, cache_len in WHISPER_BATCHES}


def encdec_greedy(cfg, params, frames, toks, kv_len, n_new: int,
                  cache_len: int, plan=None) -> dict:
    """One greedy generation through the model API as the reference's
    tests drive an encoder-decoder (``api.prefill`` with the frames, then
    ``api.decode_step``), each new token decoded as the padded engine
    decodes it (``n_new`` steps at positions kv_len + step); under ``plan``
    on this rank's slices (inputs and logits whole, as on every rank).  The
    prefill and the decode loop each run with the launch counts set to 0
    just before and read just after.  Returns their seconds and launches,
    the outputs, the shapes of each layer's (self k, v, cross ck, cv), the
    cache's layers and whether every logit was finite."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = api.prefill(cfg, params, {"frames": frames, "tokens": toks},
                                cache_len=cache_len, kv_len=kv_len, plan=plan)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = read_launches()
    shapes = sorted({tuple(tuple(t.shape) for t in (
        c["self"]["k"], c["self"]["v"], c["cross"]["ck"], c["cross"]["cv"]))
        for c in cache})
    outs = [[] for _ in range(toks.shape[0])]
    finite = bool(torch.isfinite(logits).all())
    reset_launches()
    t0 = time.perf_counter()
    for step in range(n_new):
        nxt = greedy(logits, cfg.vocab_size)
        for i, t in enumerate(nxt.tolist()):
            outs[i].append(t)
        logits, cache = api.decode_step(cfg, params, nxt[:, None].long(),
                                        cache, kv_len + step, plan=plan)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return {"prefill_s": prefill_s, "decode_s": decode_s,
            "launches": [pre, read_launches()],
            "outputs": {str(i): o for i, o in enumerate(outs)},
            "cache_shapes": [list(map(list, sh)) for sh in shapes],
            "cache_layers": len(cache),
            "finite": finite and bool(torch.isfinite(logits).all()),
            "logits_shape": list(logits.shape)}


def encdec_expected(cfg, b: int, cache_len: int, n_new: int,
                    rows: int = 1, heads: int = 1) -> tuple:
    """The launches of an ``encdec_greedy`` run (flash attention n_enc + 2
    x n_dec a prefill: encoder, decoder self, cross; the decode kernel 2 x
    n_dec a step: self, cross; no other kernel) and its cache shapes, on
    a device whose batch rows and KV heads the plan cuts ``rows`` and
    ``heads`` ways."""
    n_dec, n_enc = cfg.n_layers, cfg.n_encoder_layers
    pre = {"flash_attention": n_enc + 2 * n_dec, "decode_attention": 0,
           "paged_attention": 0, "wkv6": 0}
    dec = {"flash_attention": 0, "decode_attention": 2 * n_dec * n_new,
           "paged_attention": 0, "wkv6": 0}
    kv, hd = cfg.n_kv_heads // heads, cfg.head_dim_eff
    shapes = [[[b // rows, cache_len, kv, hd]] * 2
              + [[b // rows, WHISPER_FRAMES, kv, hd]] * 2]
    return [pre, dec], shapes


def encdec_generate(what: str, cfg, params, frames, toks, kv_len, n_new: int,
                    cache_len: int) -> dict:
    """``encdec_greedy`` on the card alone, a warm-up run and then the run
    whose numbers are kept.  Checks the launches and cache shapes of
    ``encdec_expected``, finite logits and the outputs.  Returns the record,
    the outputs and the launches of the prefill and of the decode loop."""
    encdec_greedy(cfg, params, frames, toks, kv_len, n_new, cache_len)
    run = encdec_greedy(cfg, params, frames, toks, kv_len, n_new, cache_len)
    pre, dec = run["launches"]
    (want_pre, want_dec), want_shapes = encdec_expected(
        cfg, toks.shape[0], cache_len, n_new)
    print(f"[encdec] {what} launches: prefill {pre} (expected {want_pre}); "
          f"{n_new} decode steps {dec} (expected {want_dec})", flush=True)
    if pre != want_pre or dec != want_dec:
        fail(f"whisper {what}: launches {pre}, {dec}; expected {want_pre}, "
             f"{want_dec}")
    b, f = frames.shape[:2]
    if not run["finite"] or run["logits_shape"] != [b, cfg.padded_vocab] \
            or run["cache_layers"] != cfg.n_layers \
            or run["cache_shapes"] != want_shapes:
        fail(f"whisper {what}: finite {run['finite']}, logits "
             f"{run['logits_shape']}, {run['cache_layers']} cache layers of "
             f"{run['cache_shapes']}")
    outputs = {int(k): v for k, v in run["outputs"].items()}
    check_outputs(f"whisper {what}", cfg, outputs, n=b)
    digest = serve.outputs_digest(outputs)
    tokens = b * n_new
    decode_s, prefill_s = run["decode_s"], run["prefill_s"]
    rec = {"prompt_lengths": kv_len.tolist(), "cache_len": cache_len,
           "new_tokens": n_new, "prefill_ms": prefill_s * 1e3,
           "decode_ms": decode_s * 1e3,
           "decode_ms_per_step": decode_s * 1e3 / n_new,
           "decode_tok_per_s": tokens / decode_s, "digest": digest,
           "launches_prefill": pre, "launches_decode": dec,
           "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"[encdec] {what} {kv_len.tolist()} over {f} frames: prefill "
          f"{rec['prefill_ms']:.2f} ms, decode {n_new} steps in "
          f"{rec['decode_ms']:.2f} ms ({rec['decode_ms_per_step']:.2f} ms a "
          f"step, {rec['decode_tok_per_s']:.1f} tok/s), digest {digest}; "
          f"peak device memory {rec['peak_device_gib']:.2f} GiB", flush=True)
    return {"rec": rec, "outputs": outputs, "launches": [pre, dec]}


def encdec_logits_parity(cfg, frames, toks, kv_len) -> dict:
    """Prefill and first decode-step logits of ``cfg`` (cut to
    WHISPER_PARITY_LAYERS encoder and decoder layers) on the card vs the
    CPU (plain kernel versions; the same seeded weights, drawn on the CPU
    once and a copy moved to the card), on the same frames and prompts."""
    cut = replace(cfg, n_layers=WHISPER_PARITY_LAYERS,
                  n_encoder_layers=WHISPER_PARITY_LAYERS)
    cpu_params = api.init_params(cut, seed=0, dtype=torch.float32, device="cpu")
    got = {}
    for device in ("cuda", "cpu"):
        params = copy.deepcopy(cpu_params).to(device) if device == "cuda" \
            else cpu_params
        batch = {"frames": frames.to(device), "tokens": toks.to(device)}
        lg, cache = api.prefill(cut, params, batch, cache_len=toks.shape[1] + 1,
                                kv_len=kv_len.to(device))
        nxt = greedy(lg, cut.vocab_size) if device == "cuda" \
            else got["nxt"].cpu()
        lg2, _ = api.decode_step(cut, params, nxt[:, None].long(), cache,
                                 kv_len.to(device))
        got[device] = (lg.float().cpu(), lg2.float().cpu())
        got["nxt"] = nxt
        del params, cache
    errs = {name: (got["cuda"][i] - got["cpu"][i]).abs().max().item()
            for i, name in enumerate(("prefill", "decode"))}
    for name, err in errs.items():
        print(f"[encdec] card vs CPU {name} logits at {WHISPER_PARITY_LAYERS} "
              f"encoder + {WHISPER_PARITY_LAYERS} decoder layers, full width: "
              f"max_abs_err {err:.3e} (tol {TOL_LOGITS})", flush=True)
        if not err <= TOL_LOGITS:
            fail(f"whisper card vs CPU {name} logits differ by {err}")
    return errs


def phase_encdec() -> dict:
    """whisper-medium at full width and depth (``serve.fit_depth`` must
    keep it whole), drawn once, run through the model API on seeded frames:
    a short batch and a long right-padded batch, ``[profile]`` lines of the
    long prefill and a long decode step, and card-vs-CPU logits at 2 + 2
    layers."""
    torch.cuda.empty_cache()
    full = get_config("whisper-medium")
    cfg = serve.fit_depth(full, serve.card_weight_bytes("cuda"))
    if cfg is not full:
        fail(f"whisper-medium: fit_depth cut it to {cfg.n_layers} of "
             f"{full.n_layers} layers; the card should hold it whole")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    init_s = time.perf_counter() - t0
    plan = helr_mesh(cfg, SHAPES["decode_32k"]).name
    print(f"[encdec] whisper-medium at full width and depth "
          f"({cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} "
          f"of {cfg.head_dim_eff}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
          f"padded to {cfg.padded_vocab}, {WHISPER_FRAMES} frames): "
          f"{cfg.param_count():.4g} parameters, "
          f"{4 * cfg.param_count() / 1e9:.2f} GB of f32 weights, drawn once "
          f"and moved in {init_s:.1f} s; plan for production mesh: {plan}",
          flush=True)
    frames, inputs = whisper_inputs(cfg)
    launches = {k: 0 for k in TIMED}
    runs = {}
    for what, (toks, kv_len, n_new, cache_len) in inputs.items():
        got = encdec_generate(what, cfg, params, frames, toks, kv_len, n_new,
                              cache_len)
        runs[what] = got["rec"]
        for part in got["launches"]:
            for k in launches:
                launches[k] += part[k]
    toks, kv_len = inputs["long batch"][:2]
    profile = {"whisper long prefill": step_breakdown(
        f"whisper long prefill (frames {tuple(frames.shape)}, prompts "
        f"{kv_len.tolist()})",
        lambda: api.prefill(cfg, params, {"frames": frames, "tokens": toks},
                            cache_len=WHISPER_LONG_CACHE, kv_len=kv_len))}
    lg, cache = api.prefill(cfg, params, {"frames": frames, "tokens": toks},
                            cache_len=WHISPER_LONG_CACHE, kv_len=kv_len)
    nxt = greedy(lg, cfg.vocab_size)[:, None].long()
    profile["whisper long decode step"] = step_breakdown(
        "whisper long decode step",
        lambda: api.decode_step(cfg, params, nxt, cache, kv_len))
    # a decode step reads the decoder's weights (the embedding table's 4
    # rows aside, the tied head whole) and the cross caches
    dec_params = cfg.param_count() - cfg.n_encoder_layers * (
        cfg._attn_params() + cfg._mlp_params(cfg.d_ff) + 2 * cfg.d_model)
    cross_bytes = 4 * cfg.n_layers * 4 * WHISPER_FRAMES * 2 * cfg.n_kv_heads \
        * cfg.head_dim_eff
    step_bytes = 4 * dec_params + cross_bytes
    step = profile["whisper long decode step"]
    print(f"[encdec] a decode step reads {4 * dec_params / 1e9:.2f} GB of "
          f"decoder weights and {cross_bytes / 1e9:.2f} GB of cross cache: at "
          f"least {step_bytes / H100.hbm_bw * 1e3:.3f} ms at "
          f"{H100.hbm_bw / 1e12:.2f} TB/s; the long decode step took "
          f"{step['device_busy_ms']:.3f} ms of device time "
          f"({step['wall_ms']:.2f} wall)", flush=True)
    del params, cache, lg
    torch.cuda.empty_cache()
    toks, kv_len = inputs["short batch"][:2]
    errs = encdec_logits_parity(cfg, frames, toks, kv_len)
    return {"runs": runs, "plan": plan, "init_s": init_s,
            "weight_bytes": 4 * cfg.param_count(),
            "decode_step_bytes": step_bytes,
            "decode_step_bound_ms": step_bytes / H100.hbm_bw * 1e3,
            "profile": profile, "logits_max_abs_err": errs,
            "launches": launches}


def bf16_logits_parity(tag: str, cfg, params, prompts) -> dict:
    """Prefill and first decode-step logits of one padded batch on the card,
    then on the CPU (plain kernel versions) with the card's own weights
    moved back (``params`` ends on the CPU): within TOL_BF16_LOGITS x the
    largest logit, the argmax equal in every row whose top two logits lie
    further apart than that tolerance; the smallest router margin of the
    card's MoE inputs beside them.  ``tag`` heads the printed lines."""
    got = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        if device == "cpu":
            params.to("cpu")
        moved_s = time.perf_counter() - t0
        eng = InferenceEngine(cfg, params, EngineConfig(max_batch=4,
                                                        cache_len=64))
        toks, kv_len = eng._pad_prompts(prompts)
        with moe_watch(margins=device == "cuda") as seen:
            lg, cache = eng._prefill(toks, kv_len)
            nxt = greedy(lg, cfg.vocab_size) if device == "cuda" \
                else got["nxt"].cpu()
            lg2, _ = eng._decode(nxt[:, None].long(), cache, kv_len)
        got[device] = (lg.float().cpu(), lg2.float().cpu())
        got["nxt"] = nxt
        if device == "cuda":
            margin = min(seen["margin"])
        print(f"[{tag}] logits on {device}"
              + (f" after moving the weights back in {moved_s:.1f} s"
                 if device == "cpu" else "")
              + f" in {time.perf_counter() - t0:.1f} s", flush=True)
        del eng, cache
    errs, flips = {}, {}
    for i, name in enumerate(("prefill", "decode")):
        card, cpu = got["cuda"][i][:, :cfg.vocab_size], \
            got["cpu"][i][:, :cfg.vocab_size]
        tol = TOL_BF16_LOGITS * cpu.abs().max().item()
        errs[name] = (card - cpu).abs().max().item()
        top2 = cpu.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > tol
        flips[name] = int((card.argmax(-1) != cpu.argmax(-1))[clear].sum())
        print(f"[{tag}] card vs CPU {name} logits at full width, all "
              f"{cfg.n_layers} layers, bf16: max_abs_err {errs[name]:.3e} "
              f"(tol {tol:.3e} = {TOL_BF16_LOGITS} x max |logit|); argmax "
              f"differs in {flips[name]} of the {int(clear.sum())} rows whose "
              f"top two are further apart than the tol; smallest router "
              f"top-k margin of its MoE inputs {margin:.3e}", flush=True)
        if not errs[name] <= tol or flips[name]:
            fail(f"{tag} card vs CPU {name} logits: max_abs_err "
                 f"{errs[name]} (tol {tol}), {flips[name]} argmax flips")
    return {"max_abs_err": errs, "argmax_flips": flips,
            "min_router_margin": margin}


def phase_llama4() -> dict:
    """llama4-maverick-400b-a17b at full width: ``serve.fit_depth`` raises
    in f32 and keeps one group period (2 layers) in bf16; that period drawn
    once in bf16 and served padded, continuous and paged, a 4 x 1024
    padded batch, the MoE's ``[moe]`` lines, the HELR plan, and card-vs-CPU
    logits at both layers on the card's own weights."""
    torch.cuda.empty_cache()
    full = get_config(LLAMA4)
    budget = serve.card_weight_bytes("cuda")
    try:
        serve.fit_depth(full, budget)
    except ValueError as e:
        print(f"[llama4] f32 weights: fit_depth raises: {e}", flush=True)
    else:
        fail("llama4: fit_depth kept layers in f32; not one period fits")
    cfg = serve.fit_depth(full, budget, bytes_per_param=2)
    if cfg.n_layers != 2 or [sp.mlp for sp in cfg.layer_plan()] != \
            ["dense", "moe"]:
        fail(f"llama4: fit_depth keeps {cfg.n_layers} layers in bf16; one "
             "period (dense, MoE) should fit")
    nbytes = 2 * cfg.param_count()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # drawn on the card: the host's draw of these weights took 132-209 s
    params = api.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda",
                             generator_device="cuda")
    init_s = time.perf_counter() - t0
    host_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    plan = helr_mesh(full, SHAPES["decode_32k"]).name
    m = cfg.moe
    print(f"[llama4] {LLAMA4} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} of {cfg.head_dim_eff}, "
          f"d_ff {cfg.d_ff}, {m.n_experts} experts of {m.d_expert} top-"
          f"{m.top_k} and {m.n_shared_experts} shared, vocab "
          f"{cfg.vocab_size} padded to {cfg.padded_vocab}), one group "
          f"period of {cfg.n_layers} of {full.n_layers} layers in bf16 "
          f"(fit_depth at {budget / 1e9:.1f} GB): {cfg.param_count():.4g} "
          f"parameters, {nbytes / 1e9:.2f} GB, drawn on the card in "
          f"{init_s:.1f} s (peak host memory of the process "
          f"{host_gib:.1f} GiB); plan for production mesh at decode_32k: "
          f"{plan}", flush=True)
    reqs = serve.make_requests(cfg, 12, 16)
    pcfg = serve.paged_config(cfg, reqs, 16, float(LLAMA4_BUDGET),
                              dtype_bytes=2)
    if pcfg.usable_blocks < 4 * pcfg.max_blocks:
        fail(f"llama4 paged: {pcfg.usable_blocks} pages at {LLAMA4_BUDGET} B "
             f"for 4 slots of {pcfg.max_blocks}")
    with moe_watch() as seen:
        runs, first, _ = serve_modes("llama4", "llama4", cfg, params, pcfg)
        long, profile, _ = long_batch("llama4", "llama4", cfg, params,
                                      [LONG_PROMPT] * 4, LONG_CACHE)
    launches = {k: sum(r["launches"][k] for r in list(runs.values()) + [long])
                for k in TIMED}
    moe_rec = moe_report("llama4", cfg, params, seen,
                         profile["llama4 long decode step"])
    reqs = {r.rid: r for r in reqs}
    parity = bf16_logits_parity("llama4", cfg, params,
                                [reqs[rid].tokens for rid in first])
    del params
    torch.cuda.empty_cache()
    return {"runs": runs, "plan": plan, "init_s": init_s,
            "host_peak_gib": host_gib, "weight_bytes": nbytes,
            "n_layers": cfg.n_layers, "long_batch": long, "profile": profile,
            "moe": moe_rec, "logits": parity, "launches": launches}


def mamba_prefill_times(cfg, params, b: int, t: int) -> dict:
    """Device time of one Mamba mixer's prefill (the first layer's weights)
    over seeded x [b, t, d] in the weights' dtype, and of its scan alone
    (``mamba.selective_scan`` on the same layer's f32 inputs), beside two
    bounds of the scan's bytes: the f32 [b, t, d_in, N] decays and states
    that the torch-ops scan makes, each written once and read once; and a
    fused scan's, which keeps the state on chip and moves only x and dt
    ([b, t, d_in] f32), B and C ([b, t, N] f32) and y ([b, t, d_in] f32)."""
    p = next(blk.mixer for blk, sp in zip(params.blocks, cfg.layer_plan())
             if sp.mixer == "mamba")
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(b, t, cfg.d_model, generator=gen,
                    device="cuda").to(p.in_proj.w.dtype)
    d_in, n = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    with torch.inference_mode():
        xz = x @ p.in_proj.w
        xc = mamba._causal_conv(p, xz.chunk(2, dim=-1)[0])
        dt, b_ssm, c_ssm = mamba._selective_inputs(p, xc, n)
        a, xf = -torch.exp(p.a_log), xc.float()
        torch.cuda.reset_peak_memory_stats()
        whole = timed(lambda: mamba.mamba_prefill(cfg, p, x))
        scan = timed(lambda: mamba.selective_scan(xf, dt, a, b_ssm, c_ssm,
                                                  min(256, t)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    state = 4 * b * t * d_in * n
    rec = {"tokens": b * t, "mixer_ms": whole["ms"],
           "mixer_launches": whole["launches_per_call"], "scan_ms": scan["ms"],
           "scan_call_ms": scan["call_ms"],
           "scan_launches": scan["launches_per_call"],
           "scan_bytes_unfused": 4 * state,
           "scan_bound_unfused_ms": 4 * state / H100.hbm_bw * 1e3,
           "scan_bytes_fused": 4 * b * t * (3 * d_in + 2 * n),
           "peak_device_gib": peak}
    rec["scan_bound_fused_ms"] = rec["scan_bytes_fused"] / H100.hbm_bw * 1e3
    print(f"[jamba] Mamba prefill of one layer at B x T = {b} x {t} (d_in "
          f"{d_in}, d_state {n}, chunks of 256): {whole['ms']:.2f} ms of "
          f"device time ({whole['launches_per_call']} device activities; "
          f"CUDA events {whole['call_ms']:.2f} ms), of which the scan "
          f"{scan['ms']:.2f} ms ({scan['launches_per_call']} activities, "
          f"events {scan['call_ms']:.2f} ms); the scan's f32 [B, T, d_in, N] "
          f"decays and states, each written and read once, "
          f"{4 * state / 1e9:.2f} GB: at least "
          f"{rec['scan_bound_unfused_ms']:.2f} ms at "
          f"{H100.hbm_bw / 1e12:.2f} TB/s; a fused scan's "
          f"{rec['scan_bytes_fused'] / 1e9:.3f} GB: "
          f"{rec['scan_bound_fused_ms']:.3f} ms; peak device memory "
          f"{peak:.1f} GiB", flush=True)
    return rec


def phase_jamba() -> dict:
    """jamba-1.5-large-398b at full width: ``serve.fit_depth`` raises in f32
    and in bf16 (one 8-layer group period is 90.2 GB in bf16), so the phase
    takes its first five layers (every kind of layer: Mamba with a dense
    MLP and with the MoE, and the attention layer, 48.0 GB in bf16), draws
    them once in bf16 and serves them padded and continuous (``--paged``
    and ``--no-reduced`` raise), a 4 x 1024 padded batch with ``[profile]``
    lines, the Mamba prefill's time at T = 4,096 against its bytes, the
    MoE's ``[moe]`` lines, the HELR plan, and card-vs-CPU logits at all
    five layers on the card's own weights."""
    torch.cuda.empty_cache()
    full = get_config(JAMBA)
    budget = serve.card_weight_bytes("cuda")
    for bytes_per_param in (4, 2):
        try:
            serve.fit_depth(full, budget, bytes_per_param)
        except ValueError as e:
            print(f"[jamba] {bytes_per_param} bytes a parameter: fit_depth "
                  f"raises: {e}", flush=True)
        else:
            fail(f"jamba: fit_depth kept layers at {bytes_per_param} bytes a "
                 "parameter; not one 8-layer period fits")
    for argv, what in ((["--no-reduced"], "fit_depth"),
                       (["--paged", "--requests", "2"], "the paged engine")):
        try:
            serve.main(["--arch", JAMBA, "--device", "cuda"] + argv)
        except ValueError as e:
            print(f"[jamba] serve {' '.join(argv)}: {what} raises: {e}",
                  flush=True)
        else:
            fail(f"jamba: serve {' '.join(argv)} did not raise")
    cfg = replace(full, n_layers=JAMBA_LAYERS)
    plan_seen = [(sp.mixer, sp.mlp) for sp in cfg.layer_plan()]
    nbytes = 2 * cfg.param_count()
    if plan_seen != JAMBA_PLAN or nbytes > budget:
        fail(f"jamba: {JAMBA_LAYERS} layers plan {plan_seen}, {nbytes} bytes "
             f"in bf16 against a budget of {budget}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # drawn on the card: the host's draw of these weights took 132-209 s
    params = api.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda",
                             generator_device="cuda")
    init_s = time.perf_counter() - t0
    host_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    plan = helr_mesh(full, SHAPES["decode_32k"]).name
    m, mc = cfg.moe, cfg.mamba
    print(f"[jamba] {JAMBA} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} of {cfg.head_dim_eff}, "
          f"no positions; Mamba d_inner {mc.expand * cfg.d_model}, d_state "
          f"{mc.d_state}, d_conv {mc.d_conv}; d_ff {cfg.d_ff}, "
          f"{m.n_experts} experts of {m.d_expert} top-{m.top_k}; vocab "
          f"{cfg.vocab_size}), its first {cfg.n_layers} of {full.n_layers} "
          f"layers {plan_seen} in bf16: {cfg.param_count():.4g} parameters, "
          f"{nbytes / 1e9:.2f} GB (budget {budget / 1e9:.1f} GB), drawn on the "
          f"card in {init_s:.1f} s (peak host memory of the process "
          f"{host_gib:.1f} GiB); plan for production mesh at decode_32k: "
          f"{plan}", flush=True)
    with moe_watch() as seen:
        runs, first, _ = serve_modes("jamba", "jamba", cfg, params)
        long, profile, _ = long_batch("jamba", "jamba", cfg, params,
                                      [LONG_PROMPT] * 4, LONG_CACHE)
    launches = {k: sum(r["launches"][k] for r in list(runs.values()) + [long])
                for k in TIMED}
    scan = mamba_prefill_times(cfg, params, 4, LONG_PROMPT)
    n_mamba = sum(sp.mixer == "mamba" for sp in cfg.layer_plan())
    prefill = profile["jamba long prefill"]["device_busy_ms"]
    scan["share_of_long_prefill"] = n_mamba * scan["scan_ms"] / prefill
    print(f"[jamba] the {n_mamba} Mamba scans take "
          f"{n_mamba * scan['scan_ms']:.2f} ms of the long prefill's "
          f"{prefill:.2f} ms of device time "
          f"({scan['share_of_long_prefill']:.3f})", flush=True)
    moe_rec = moe_report("jamba", cfg, params, seen,
                         profile["jamba long decode step"])
    reqs = {r.rid: r for r in serve.make_requests(cfg, 12, 16)}
    parity = bf16_logits_parity("jamba", cfg, params,
                                [reqs[rid].tokens for rid in first])
    host_after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"[jamba] peak host memory of the process after the CPU run: "
          f"{host_after:.1f} GiB", flush=True)
    del params
    torch.cuda.empty_cache()
    return {"runs": runs, "plan": plan, "init_s": init_s,
            "host_peak_gib": host_gib, "host_peak_after_parity_gib": host_after,
            "weight_bytes": nbytes, "n_layers": cfg.n_layers,
            "long_batch": long, "profile": profile, "mamba_prefill": scan,
            "moe": moe_rec, "logits": parity, "launches": launches}


def train_launches(what: str, steps: int, n_layers: int) -> dict:
    """K2 once per layer, micro-batch and step forward, its gradient as
    many times backward, no other kernel."""
    got = read_launches() | {"flash_attention_backward":
                             flash_attention.backward_calls}
    want = {k: 0 for k in got} | {"flash_attention": n_layers * steps,
                                  "flash_attention_backward": n_layers * steps}
    print(f"[train] {what} launches {got} (expected {want})", flush=True)
    if got != want:
        fail(f"{what}: kernel launches {got}, expected {want}")
    return got


def train_parity(cfg, params) -> dict:
    """One loss and gradient of the phase's own weights, cut to their first
    TRAIN_PARITY_LAYERS layers, at 4 x TRAIN_PARITY_SEQ tokens: on the card
    (K2 and its gradient) against the same weights moved to the CPU (plain
    versions)."""
    cut = replace(cfg, n_layers=TRAIN_PARITY_LAYERS)
    keep = {k: v.detach().cpu() for k, v in params.state_dict().items()
            if not k.startswith("blocks.")
            or int(k.split(".")[1]) < TRAIN_PARITY_LAYERS}
    base = train.token_base(cfg, 4, TRAIN_PARITY_SEQ)
    res = {}
    for device in ("cuda", "cpu"):
        model = api.init_params(cut, seed=0, device="cpu")
        model.load_state_dict(keep)
        model.to(device).requires_grad_(True)
        loss, _ = api.loss_fn(cut, model, train.batch_at(base, 0, device))
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        res[device] = (loss.item(), {n: g.detach().cpu()
                                     for n, g in zip(named, grads)})
    loss_rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    worst, worst_name = 0.0, None
    for name, ref in res["cpu"][1].items():
        err = (res["cuda"][1][name] - ref).abs().max().item() \
            / max(ref.abs().max().item(), 1e-30)
        if err > worst or worst_name is None:
            worst, worst_name = err, name
    rec = {"layers": TRAIN_PARITY_LAYERS, "seq": TRAIN_PARITY_SEQ,
           "loss_card": res["cuda"][0], "loss_cpu": res["cpu"][0],
           "loss_rel_err": loss_rel, "loss_tol": TOL_TRAIN_LOSS,
           "grad_rel_err": worst, "grad_worst_leaf": worst_name,
           "grad_tol": TOL_TRAIN_GRAD, "leaves": len(res["cpu"][1])}
    print(f"[train] card vs CPU, the first {TRAIN_PARITY_LAYERS} layers at "
          f"4 x {TRAIN_PARITY_SEQ}: loss {rec['loss_card']:.6f} vs "
          f"{rec['loss_cpu']:.6f} (rel {loss_rel:.2e}, tol {TOL_TRAIN_LOSS}); "
          f"gradients of {rec['leaves']} leaves, worst {worst:.2e} of the "
          f"leaf's largest |g| ({worst_name}; tol {TOL_TRAIN_GRAD})",
          flush=True)
    if not (loss_rel <= TOL_TRAIN_LOSS and worst <= TOL_TRAIN_GRAD):
        fail("training card vs CPU: loss or gradients out of bounds")
    return rec


def phase_train() -> dict:
    """smollm-135m at full width and depth trains on the card through the
    train CLI: AdamW for TRAIN_STEPS steps of 4 x 1024 tokens, checkpointed
    at step 20; the checkpoint restored into fresh tensors and the steps
    after it rerun (their step time, tokens a second and one profiled
    step); Adafactor for ADAFACTOR_STEPS; card vs CPU at 2 layers."""
    cfg = get_config("smollm-135m")
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    run = train.main([*TRAIN_ARGS, "--steps", str(TRAIN_STEPS),
                      "--ckpt-dir", str(TRAIN_CKPT)])
    launches = train_launches("adamw", TRAIN_STEPS, cfg.n_layers)
    losses = run["losses"]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"train: losses {losses[0]} -> {losses[-1]} did not fall")
    print(f"[train] adamw: {TRAIN_STEPS} steps of {TRAIN_TOKENS} tokens, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, {run['seconds']:.2f} s "
          f"(first step included), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del run
    torch.cuda.empty_cache()

    mgr = CheckpointManager(TRAIN_CKPT)
    tcfg = TrainConfig(opt=OptConfig(kind="adamw", lr=1e-3))
    params, opt = init_training(cfg, 1, tcfg, device="cuda")   # fresh tensors
    tree, start = mgr.restore(train_state_tree(cfg, params, opt),
                              device="cuda")
    opt = load_train_state(params, tree)
    del tree
    ckpt_bytes = sum(f.stat().st_size for f in TRAIN_CKPT.rglob("*.npy"))
    step_fn = make_train_step(cfg, None, tcfg)
    base = train.token_base(cfg, 4, 1024)
    relosses, walls = [], []
    for step in range(start, TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, train.batch_at(base, step, "cuda"),
                                 step)
        relosses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    resume_err = max(abs(a - b) / abs(b)
                     for a, b in zip(relosses, losses[start:]))
    step_s = statistics.median(walls)
    print(f"[train] checkpoint round trip: step {start} ({ckpt_bytes / 1e9:.2f} "
          f"GB on disk) restored into fresh tensors on the card, steps "
          f"{start}-{TRAIN_STEPS - 1} rerun: losses within {resume_err:.2e} "
          f"relative of the first run's (tol {TOL_RESUME})", flush=True)
    if not resume_err <= TOL_RESUME:
        fail("train: the resumed run's losses left the first run's")
    print(f"[train] step {step_s * 1e3:.2f} ms (median of {len(walls)}, the "
          f"loss read back each step), {TRAIN_TOKENS / step_s:.0f} tokens/s",
          flush=True)
    held = {"p": params, "o": opt}
    batch = train.batch_at(base, TRAIN_STEPS, "cuda")

    def one_step():
        held["p"], held["o"], _ = step_fn(held["p"], held["o"], batch,
                                          TRAIN_STEPS)
    profile = step_breakdown("train step (smollm-135m, 4 x 1024, AdamW)",
                             one_step)
    parity = train_parity(cfg, held["p"])
    del held, params, opt
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)

    reset_launches()
    ada = train.main([*TRAIN_ARGS, "--steps", str(ADAFACTOR_STEPS),
                      "--optimizer", "adafactor"])
    ada_launches = train_launches("adafactor", ADAFACTOR_STEPS, cfg.n_layers)
    if not all(math.isfinite(x) for x in ada["losses"]) \
            or ada["losses"][-1] >= ada["losses"][0]:
        fail(f"train adafactor: losses {ada['losses']} did not fall")
    print(f"[train] adafactor: {ADAFACTOR_STEPS} steps, loss "
          f"{ada['losses'][0]:.4f} -> {ada['losses'][-1]:.4f}, "
          f"{ada['seconds']:.2f} s", flush=True)
    del ada
    torch.cuda.empty_cache()
    return {"launches": {k: launches[k] + ada_launches[k] for k in launches},
            "losses": losses, "resumed_losses": relosses,
            "resume_rel_err": resume_err, "resume_step": start,
            "checkpoint_bytes": ckpt_bytes, "step_ms": step_s * 1e3,
            "step_walls_ms": [w * 1e3 for w in walls],
            "tokens_per_s": TRAIN_TOKENS / step_s, "profile": profile,
            "parity": parity}


# ---------------------------------------------------------------- phase 16

def sharded_cfg(model: str, layers: int = SHARDED_CHATGLM2_LAYERS):
    """Phase 16's configs: chatglm2-6b at full width and ``layers`` of its
    28 (phase 18 keeps 14); qwen2-moe-a2.7b at full width and 2 of its 24,
    at capacity factor 8 (no drops), so that its batch-sharded block is
    the unsharded function and the tokens can be held to one card's."""
    if model == "chatglm2":
        return replace(get_config("chatglm2-6b"), n_layers=layers)
    cfg = get_config("qwen2-moe-a2.7b")
    return replace(cfg, n_layers=SHARDED_MOE_LAYERS, moe=replace(
        cfg.moe, capacity_factor=SHARDED_MOE_CAPACITY))


def sharded_draw(cfg):
    """Full weights drawn on the card from the seeded CUDA generator: the
    same on every rank and in the single-device run."""
    return api.init_params(cfg, seed=0, dtype=torch.float32, device="cuda",
                           generator_device="cuda")


def sharded_batches(cfg, long: bool) -> list:
    """The 12 serve requests in batches of 4, in rid order, and with
    ``long`` a 4 x SHARDED_LONG_PROMPT-token batch (SHARDED_LONG_NEW new
    tokens each)."""
    reqs = serve.make_requests(cfg, 12, 16)
    batches = [Batch(requests=reqs[i:i + 4]) for i in range(0, 12, 4)]
    if long:
        rng = np.random.default_rng(16)
        batches.append(Batch(requests=[
            Request(rid=100 + i, tokens=p, input_len=len(p), slo=1e9,
                    arrival=0.0, true_output_len=SHARDED_LONG_NEW)
            for i, p in enumerate(rng.integers(
                2, cfg.vocab_size, (4, SHARDED_LONG_PROMPT)).tolist())]))
    return batches


def kernel_counts(names) -> dict:
    return {k: sum(COLD[k] in n for n in names)
            for k in ("flash_attention", "decode_attention")}


def sharded_serve(cfg, params, plan, long: bool, clock=None) -> dict:
    """Serve phase 16's batches on ``params``: one card's model (``plan``
    None) or this rank's slices under ``plan`` (every rank runs the same
    calls).  First the first batch's prefill and first decode-step logits
    (and a warm-up); then that batch once more with rank 0 under
    torch.profiler when ``profile`` (each kernel's device activities); then
    every batch with the launch counts set to 0 just before and read just
    after."""
    ecfg = EngineConfig(max_batch=4, cache_len=SHARDED_CACHE, max_new_tokens=16)
    eng = InferenceEngine(cfg, params, ecfg, plan=plan)
    long_eng = InferenceEngine(cfg, params, replace(
        ecfg, cache_len=SHARDED_LONG_CACHE, max_new_tokens=SHARDED_LONG_NEW),
        plan=plan)
    batches = sharded_batches(cfg, long)
    toks, kv_len = eng._pad_prompts([r.tokens for r in batches[0].requests])
    lg, cache = eng._prefill(toks, kv_len)
    lg2, _ = eng._decode(greedy(lg, cfg.vocab_size)[:, None].long(), cache,
                         kv_len)
    logits = torch.stack([lg[:4], lg2[:4]]).float().cpu().numpy()
    del cache, lg, lg2
    true = {r.rid: r.true_output_len for b in batches for r in b.requests}
    seen = None
    if plan is not None:
        rank0 = dist.get_rank() == 0
        for _ in range(3):      # rank 0 retries a window that lost its spins
            ok = torch.ones(1)
            if rank0:
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(PAD_SPINS):
                        torch.cuda._sleep(50)
                    res = eng.run_batch(batches[0], true_lens=true)
                    torch.cuda.synchronize()
                names = [e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
                ok[0] = float(any(SPIN in n for n in names))
                seen = {**kernel_counts(names), "steps": res.steps}
            else:
                eng.run_batch(batches[0], true_lens=true)
            dist.broadcast(ok, 0)
            if ok[0]:
                break
        else:
            seen = {"lost": True}
    torch.cuda.synchronize()
    reset_launches()
    if clock is not None:
        clock.reset()
    outs, runs = {}, []
    for b in batches:
        e = long_eng if len(b.requests[0].tokens) == SHARDED_LONG_PROMPT \
            else eng
        res = e.run_batch(b, true_lens=true)
        outs.update(res.outputs)
        runs.append({"prompt": max(len(r.tokens) for r in b.requests),
                     "prefill_ms": res.prefill_s * 1e3,
                     "decode_ms": res.decode_s * 1e3, "steps": res.steps})
    torch.cuda.synchronize()
    return {"outputs": {str(k): v for k, v in outs.items()}, "logits": logits,
            "launches": read_launches(), "batches": runs, "profiled": seen,
            "gloo": clock.read() if clock is not None else None,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


class GlooClock:
    """Calls of the process group's collectives and the host seconds spent
    in them (the staging copies to and from the card excluded), counted by
    wrapping ``torch.distributed``'s functions in this rank."""

    NAMES = ("all_reduce", "all_gather", "all_to_all_single")

    def __init__(self):
        self.reset()
        for name in self.NAMES:
            setattr(dist, name, self._timed(getattr(dist, name)))

    def _timed(self, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.calls += 1
                self.seconds += time.perf_counter() - t0
        return call

    def reset(self) -> None:
        self.calls, self.seconds = 0, 0.0

    def read(self) -> dict:
        return {"calls": self.calls, "s": self.seconds}


def sharded_rank(rank: int, out_dir: str) -> None:
    """One of phase 16's ranks on the card: every run of SHARDED_RUNS under
    its mesh and plan, its weights drawn in turn (one full copy on the card
    at a time) and cut to this rank's slices.  Writes its records and, on
    rank 0, the gathered logits."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes = {shape: Mesh({"data": shape[0], "model": shape[1]}, device="cuda")
              for shape in dict.fromkeys(r[2] for r in SHARDED_RUNS)}
    recs = {}
    gloo, dec = GlooClock(), DecodeShapes()
    for name, model, shape, plan, long in SHARDED_RUNS:
        cfg = sharded_cfg(model)
        torch.cuda.reset_peak_memory_stats()
        with set_mesh(meshes[shape]):
            t0 = time.perf_counter()
            for turn in range(dist.get_world_size()):
                if turn == rank:
                    params = sharded_draw(cfg)
                    shard_params(cfg, params, plan)
                    torch.cuda.empty_cache()
                dist.barrier()
            draw_s = time.perf_counter() - t0
            rec = sharded_serve(cfg, params, plan, long, clock=gloo)
            del params
            torch.cuda.empty_cache()
        if rank == 0:
            np.save(Path(out_dir) / f"{name}.npy", rec["logits"])
        recs[name] = {k: v for k, v in rec.items() if k != "logits"} | {
            "draw_s": draw_s}
    recs["shapes"] = {"decode": dec.read()}
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(recs))


def phase_sharded() -> dict:
    """chatglm2-6b (and qwen2-moe-a2.7b) served on one card, then by 4
    ranks sharing it over gloo under each plan of SHARDED_RUNS: tokens
    against the card's, the largest logit difference, K2 and K3 launches
    (each rank's wrapper counts, and rank 0's device activities of one
    batch under torch.profiler) against layers x calls, step times."""
    out_dir = ROOT / "build" / "sharded"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    launches = {k: 0 for k in TIMED}
    single = {}
    for model in dict.fromkeys(r[1] for r in SHARDED_RUNS):
        cfg = sharded_cfg(model)
        params = sharded_draw(cfg)
        long = any(r[4] for r in SHARDED_RUNS if r[1] == model)
        single[model] = sharded_serve(cfg, params, None, long)
        for k in launches:
            launches[k] += single[model]["launches"][k]
        del params
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_ranks(sharded_rank, (str(out_dir),), world=SHARDED_WORLD,
              timeout=300.0, join_timeout=600.0)
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(SHARDED_WORLD)]
    print(f"[sharded] {SHARDED_WORLD} ranks on one card over gloo: "
          f"{ranks_s:.1f} s from spawn to join", flush=True)
    out = {"ranks_s": ranks_s, "runs": {}, "shapes": shape_coverage(
        "sharded", [r["shapes"] for r in ranks], need_grad=False)}
    for name, model, shape, plan, long in SHARDED_RUNS:
        cfg, ref = sharded_cfg(model), single[model]
        rec = ranks[0][name]
        same, total = agreement(rec["outputs"], ref["outputs"])
        err = float(np.abs(np.load(out_dir / f"{name}.npy")
                           - ref["logits"]).max())
        layers = kernel_layers(cfg)
        prefills = len(rec["batches"])
        steps = sum(b["steps"] for b in rec["batches"])
        head_tp = cfg.n_kv_heads % shape[1] == 0
        want = {"flash_attention": layers * prefills,
                "decode_attention": layers * steps if head_tp else 0}
        got = [{k: r[name]["launches"][k] for k in want} for r in ranks]
        prof = rec["profiled"]
        prof_want = {"flash_attention": layers,
                     "decode_attention": layers * prof.get("steps", 0)
                     if head_tp else 0}
        for r in ranks:
            for k in launches:
                launches[k] += r[name]["launches"][k]
        step_ms = sum(b["decode_ms"] for b in rec["batches"]) / steps
        run_s = sum(b["prefill_ms"] + b["decode_ms"] for b in rec["batches"]) / 1e3
        ref_step = sum(b["decode_ms"] for b in ref["batches"]) / steps
        print(f"[sharded] {name} on {{data: {shape[0]}, model: {shape[1]}}}: tokens "
              f"{same}/{total} equal to one card's; logits max_abs_err "
              f"{err:.3e} (tol {TOL_LOGITS}); launches a rank {got} "
              f"(expected {want}); rank 0 profiled one batch: {prof} "
              f"(expected {prof_want}); decode {step_ms:.2f} ms a step "
              f"(one card {ref_step:.2f}); draw and shard {rec['draw_s']:.1f} "
              f"s; peak {max(r[name]['peak_gib'] for r in ranks):.1f} GiB a "
              f"rank; rank 0's collectives: {rec['gloo']['calls']} calls, "
              f"{rec['gloo']['s']:.2f} s in gloo of the batches' {run_s:.2f} "
              "s", flush=True)
        for b, rb in zip(rec["batches"], ref["batches"]):
            print(f"[sharded] {name} batch of prompts <= {b['prompt']}: "
                  f"prefill {b['prefill_ms']:.1f} ms (one card "
                  f"{rb['prefill_ms']:.1f}), {b['steps']} steps in "
                  f"{b['decode_ms']:.1f} ms (one card {rb['decode_ms']:.1f})",
                  flush=True)
        if same != total or rec["outputs"] != ref["outputs"]:
            fail(f"sharded {name}: {same}/{total} tokens equal one card's")
        if not err <= TOL_LOGITS:
            fail(f"sharded {name}: logits differ from one card's by {err}")
        if any(g != want for g in got) or want["flash_attention"] <= 0:
            fail(f"sharded {name}: launches {got}, expected {want}")
        if prof.get("lost") or {k: prof[k] for k in prof_want} != prof_want:
            fail(f"sharded {name}: profiled {prof}, expected {prof_want}")
        out["runs"][name] = {
            "mesh": list(shape), "plan": asdict(plan), "tokens_equal": [same, total],
            "logits_max_abs_err": err, "launches_per_rank": got,
            "profiled_rank0": prof, "decode_ms_per_step": step_ms,
            "one_card_decode_ms_per_step": ref_step, "batches": rec["batches"],
            "one_card_batches": ref["batches"], "draw_s": rec["draw_s"],
            "gloo_rank0": rec["gloo"],
            "peak_gib": [r[name]["peak_gib"] for r in ranks]}
    out["launches"] = launches
    return out


# ---------------------------------------------------------------- phase 17

def sharded_train_cfg(model: str):
    """Phase 17's configs: phase 16's at SHARDED_TRAIN_LAYERS layers."""
    return replace(sharded_cfg(model), n_layers=SHARDED_TRAIN_LAYERS[model])


def tensor_bytes(tensors) -> int:
    """Bytes of ``tensors`` (an iterable)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def train_bytes(named: dict, opt_state: dict) -> int:
    """Bytes of the parameters and the optimizer state this process holds."""
    return tensor_bytes(named.values()) + opt_bytes(opt_state)


def opt_bytes(opt_state: dict) -> int:
    """Bytes of an optimizer state."""
    return tensor_bytes(t for part in opt_state.values() for t in part.values())


def step_gradients(cfg, plan, params, batch: dict, microbatches: int,
                   shards: int = 1) -> tuple:
    """(loss, gradients) of a train step: ``trainer.value_and_grad``'s, or
    for the card alone's batch-sharded MoE (``shards`` > 1: its capacity
    and lb_loss are per shard) their mean over the shards' rows."""
    if shards == 1:
        loss, _, grads = trainer.value_and_grad(cfg, plan, params, batch,
                                                microbatches)
        return loss, grads
    parts = [trainer.value_and_grad(
        cfg, None, params, {k: v.chunk(shards)[j] for k, v in batch.items()},
        microbatches) for j in range(shards)]
    return (sum(p[0] for p in parts) / shards,
            {k: sum(p[2][k] for p in parts) / shards for k in parts[0][2]})


def alone_step(cfg, tcfg, shards: int):
    """The card alone's train step for a batch-sharded MoE: the mean
    gradients of ``step_gradients``, then the port's clip and update."""
    def step(params, opt, batch, i):
        loss, grads = step_gradients(cfg, None, params, batch,
                                     tcfg.microbatches, shards)
        gnorm = trainer.clip_and_update(cfg, None, tcfg, params, opt, grads, i)
        return params, opt, {"loss": loss, "grad_norm": gnorm}
    return step


class FlashShapes:
    """The shapes at which the attention module calls K2's wrapper in this
    process, as FLASH_CASES rows without their names: every call, and
    those under grad (the forwards whose backward runs K2's gradient),
    recorded by wrapping ``models.attention.flash_attention``."""

    def __init__(self):
        self.calls, self.grad = set(), set()
        orig = self.orig = attention.flash_attention

        def logged(q, k, v, **kw):
            row = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                   q.shape[3], v.shape[3], kw.get("causal", True),
                   kw.get("window"), kw.get("softcap"),
                   int(kw.get("q_offset", 0)))
            self.calls.add(row)
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in (q, k, v)):
                self.grad.add(row)
            return orig(q, k, v, **kw)
        attention.flash_attention = logged

    def read(self) -> dict:
        return {"calls": sorted(self.calls, key=str),
                "grad": sorted(self.grad, key=str)}

    def close(self) -> None:
        """Put the wrapper back: a recorder in the parent process, whose
        later phases call K2 unrecorded."""
        attention.flash_attention = self.orig


def sharded_train_run(cfg, params, plan, tcfg, steps: int, gloo, step1,
                      shards: int = 1, batch_at=None) -> dict:
    """Step 1's gradients handed to ``step1`` (one pass of its own, before
    the steps), then ``steps`` train steps through ``make_train_step``
    (or, for the card alone's batch-sharded MoE, ``alone_step``) with the
    launch counts set to 0 just before and read just after (K2's forward
    and its gradient): each step's loss, grad_norm and wall time, the bytes
    of parameters and state, the peak memory, the calls and seconds in
    gloo (``gloo``, a ``GlooClock``, or None on the card alone).  Step
    i's batch is ``batch_at(i)``, by default the train launcher's rolled
    tokens, SHARDED_TRAIN_BATCH x SHARDED_TRAIN_SEQ."""
    if batch_at is None:
        base = train.token_base(cfg, SHARDED_TRAIN_BATCH, SHARDED_TRAIN_SEQ)

        def batch_at(i):
            return train.batch_at(base, i, "cuda")
    named = {k: p.detach() for k, p in params.named_parameters()}
    opt = init_opt_state(named, tcfg.opt, stacked_leaves(cfg, named))
    step_fn = make_train_step(cfg, plan, tcfg) if shards == 1 \
        else alone_step(cfg, tcfg, shards)
    step1(step_gradients(cfg, plan, params, batch_at(0), tcfg.microbatches,
                         shards)[1])
    torch.cuda.synchronize()
    step1_gib = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()        # the comparison's gathered leaves
    free = [torch.cuda.mem_get_info()[0]]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    if gloo is not None:
        gloo.reset()
    losses, norms, walls = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch_at(i), i)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        walls.append(time.perf_counter() - t0)
        free.append(torch.cuda.mem_get_info()[0])
    launches = {"flash_attention": flash_attention.launches,
                "flash_attention_backward": flash_attention.backward_calls,
                "others": sum(v for k, v in read_launches().items()
                              if k != "flash_attention")}
    return {"losses": losses, "grad_norms": norms,
            "step_ms": [w * 1e3 for w in walls], "launches": launches,
            "bytes": train_bytes(named, opt),
            "param_bytes": tensor_bytes(named.values()),
            "opt_bytes": opt_bytes(opt),
            "gloo": gloo.read() if gloo is not None else None,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
            "step1_peak_gib": step1_gib, "free_gib": min(free) / 2**30}


def sharded_train_rank(rank: int, out_dir: str) -> None:
    """One of phase 17's ranks on the card.  For each model rank 0 first
    trains it on the card alone (every rank's copy of the weights is drawn
    from the same seeded CUDA generator) and keeps its step-1 gradients in
    host memory (a leaf visits the card only for its comparison, so rank 0
    needs no more of the shared card than the others); then every rank runs each of SHARDED_TRAIN_RUNS on its slices: its
    losses and grad norms, and rank 0 the largest error of each gathered
    step-1 gradient leaf against the card alone's.  Each rank also records
    the shapes at which it called K2 (``FlashShapes``)."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = Mesh({"data": 2, "model": 2}, device="cuda")
    gloo, shapes, dec = GlooClock(), FlashShapes(), DecodeShapes()
    recs = {}
    for model in SHARDED_TRAIN_LAYERS:
        cfg = sharded_train_cfg(model)
        runs = [r for r in SHARDED_TRAIN_RUNS if r[1] == model]
        shards = 2 if cfg.moe is not None else 1     # the data axis
        alone = {}
        if rank == 0:
            params = sharded_draw(cfg).requires_grad_(True)
            tcfg = TrainConfig(opt=OptConfig(kind=runs[0][3]),
                               microbatches=runs[0][2].microbatches)
            recs[f"{model} alone"] = sharded_train_run(
                cfg, params, None, tcfg, runs[0][4], gloo,
                lambda grads: alone.update(
                    {k: g.to("cpu") for k, g in grads.items()}),
                shards)
            del params
            torch.cuda.empty_cache()
        dist.barrier()
        for name, _, plan, optimizer, steps in runs:
            errs = {}

            def compare(grads):
                for k, g in grads.items():
                    full = gather_tensor(g, specs[k])
                    if rank == 0:
                        ref = alone[k].to(full.device)
                        errs[k] = ((full - ref).abs().max()
                                   / ref.abs().max().clamp_min(1e-30)).item()
                    del full
            with set_mesh(mesh):
                t0 = time.perf_counter()
                for turn in range(dist.get_world_size()):
                    if turn == rank:
                        params = sharded_draw(cfg)
                        shard_params(cfg, params, plan)
                        params.requires_grad_(True)
                        torch.cuda.empty_cache()
                    dist.barrier()
                draw_s = time.perf_counter() - t0
                specs = {k: p.shard_spec for k, p in params.named_parameters()}
                tcfg = TrainConfig(opt=OptConfig(kind=optimizer),
                                   microbatches=plan.microbatches)
                rec = sharded_train_run(cfg, params, plan, tcfg, steps,
                                        gloo, compare)
                del params
                torch.cuda.empty_cache()
            worst = max(errs, key=errs.get) if errs else None
            recs[name] = rec | {"draw_s": draw_s, "grad_rel_err":
                                errs.get(worst), "grad_worst_leaf": worst,
                                "leaves": len(errs)}
        alone.clear()
        torch.cuda.empty_cache()
    recs["k2_shapes"] = shapes.read() | {"decode": dec.read()}
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(recs))


class PagedShapes:
    """The shapes at which the attention module calls K1's wrappers in this
    process, as PAGED_CASES rows without their names and lengths (entry,
    b, t, h, kv, d, dv, bs, nb, n, softcap), recorded by wrapping
    ``models.attention.paged_decode_attention`` and
    ``paged_window_attention``."""

    def __init__(self):
        self.calls = set()
        for entry, name in (("decode", "paged_decode_attention"),
                            ("window", "paged_window_attention")):
            setattr(attention, name, self._logged(entry,
                                                  getattr(attention, name)))

    def _logged(self, entry, orig):
        def logged(q, k_pool, v_pool, tables, lengths, **kw):
            t = q.shape[1] if entry == "window" else 1
            self.calls.add((entry, q.shape[0], t, q.shape[-2], k_pool.shape[2],
                            q.shape[-1], v_pool.shape[3], k_pool.shape[1],
                            tables.shape[1], k_pool.shape[0],
                            kw.get("softcap")))
            return orig(q, k_pool, v_pool, tables, lengths, **kw)
        return logged

    def read(self) -> list:
        return sorted(self.calls, key=str)


class WKV6Shapes:
    """The shapes at which the RWKV-6 block calls K4's wrapper in this
    process, as WKV6_CASES rows without their name and decay (b, t, h, d,
    dv, chunk, s0 given), recorded by wrapping ``models.rwkv.wkv6``."""

    def __init__(self):
        self.calls = set()
        orig = rwkv_model.wkv6

        def logged(r, k, v, w, u, s0=None, **kw):
            self.calls.add((*r.shape, v.shape[3], kw.get("chunk", 32),
                            s0 is not None))
            return orig(r, k, v, w, u, s0, **kw)
        rwkv_model.wkv6 = logged

    def read(self) -> list:
        return sorted(self.calls, key=str)


class DecodeShapes:
    """The shapes at which the attention module calls K3's wrapper in this
    process, as DECODE_CASES rows without their name and lengths (b, s, h,
    kv, d, dv, softcap, window), recorded by wrapping
    ``models.attention.decode_attention``."""

    def __init__(self):
        self.calls = set()
        orig = self.orig = attention.decode_attention

        def logged(q, k, v, kv_len, **kw):
            self.calls.add((q.shape[0], k.shape[1], q.shape[1], k.shape[2],
                            q.shape[2], v.shape[3], kw.get("softcap"),
                            kw.get("window")))
            return orig(q, k, v, kv_len, **kw)
        attention.decode_attention = logged

    def read(self) -> list:
        return sorted(self.calls, key=str)

    def close(self) -> None:
        """Put the wrapper back (``FlashShapes.close``)."""
        attention.decode_attention = self.orig


def shape_coverage(tag: str, seen: list, need_grad: bool = True) -> dict:
    """Fail unless every shape at which a phase's ranks called K2 is a
    FLASH_CASES row, every one under grad a GRAD_CASES row too, every one
    at which they called K1 a PAGED_CASES row, every one at which they
    called K3 a DECODE_CASES row and every one at which they called K4 a
    WKV6_CASES row: the parity phase has held the kernel, and K2's
    gradient, against the plain version at each.  ``seen``: each rank's
    {"calls", "grad"} of ``FlashShapes``, {"paged"} of ``PagedShapes``,
    {"decode"} of ``DecodeShapes`` and {"wkv6"} of ``WKV6Shapes``."""
    def rows(key):
        return {tuple(r) for s in seen for r in s.get(key, ())}
    calls, grad, paged, dec, wkv = (rows(k) for k in (
        "calls", "grad", "paged", "decode", "wkv6"))
    names = {tuple(c[1:]): c[0] for c in FLASH_CASES}
    grad_names = {tuple(c[1:]): c[0] for c in GRAD_CASES}
    paged_names = {tuple(c[1:12]): c[0] for c in PAGED_CASES}
    dec_names = {tuple(c[1:9]): c[0] for c in DECODE_CASES}
    wkv_names = {tuple(c[1:7]) + (c[9],): c[0] for c in WKV6_CASES}
    missing = sorted((calls - set(names)) | (grad - set(grad_names))
                     | (paged - set(paged_names)) | (dec - set(dec_names))
                     | (wkv - set(wkv_names)), key=str)
    print(f"[{tag}] K2 shapes: {len(calls)} "
          f"({sorted(names.get(r, '?') for r in calls)}), under grad "
          f"{len(grad)} ({sorted(grad_names.get(r, '?') for r in grad)}); "
          f"K1 shapes: {len(paged)} "
          f"({sorted(paged_names.get(r, '?') for r in paged)}); "
          f"K3 shapes: {len(dec)} "
          f"({sorted(dec_names.get(r, '?') for r in dec)}); "
          f"K4 shapes: {len(wkv)} "
          f"({sorted(wkv_names.get(r, '?') for r in wkv)}); "
          f"with no parity case: {missing}", flush=True)
    if missing or (need_grad and not grad):
        fail(f"{tag}: K1/K2/K3/K4 shapes with no parity case: {missing}")
    return {"calls": sorted(names[r] for r in calls),
            "grad": sorted(grad_names[r] for r in grad),
            "paged": sorted(paged_names[r] for r in paged),
            "decode": sorted(dec_names[r] for r in dec),
            "wkv6": sorted(wkv_names[r] for r in wkv)}


def phase_sharded_train() -> dict:
    """Training under a plan on 4 ranks sharing the card (SHARDED_TRAIN_RUNS):
    every rank's loss and grad_norm at every step against the card alone's
    run from the same weights, step 1's gathered gradients against the
    card alone's, K2's forward on each rank exactly layers x micro-batches
    x steps x 2 (remat runs it again in the backward) and its gradient
    layers x micro-batches x steps, no other kernel; every K2 shape a
    parity case (``shape_coverage``); step times beside the card alone's,
    rank 0's bytes a device."""
    out_dir = ROOT / "build" / "sharded_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    run_ranks(sharded_train_rank, (str(out_dir),), world=SHARDED_WORLD,
              timeout=300.0, join_timeout=600.0)
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(SHARDED_WORLD)]
    print(f"[sharded_train] {SHARDED_WORLD} ranks on one card over gloo: "
          f"{ranks_s:.1f} s from spawn to join", flush=True)
    out = {"ranks_s": ranks_s, "runs": {},
           "k2_shapes": shape_coverage("sharded_train",
                                       [r["k2_shapes"] for r in ranks])}
    launches = {k: 0 for k in TIMED}
    launches["flash_attention_backward"] = 0
    for model in SHARDED_TRAIN_LAYERS:
        alone = ranks[0][f"{model} alone"]
        launches["flash_attention"] += alone["launches"]["flash_attention"]
        launches["flash_attention_backward"] += \
            alone["launches"]["flash_attention_backward"]
        out["runs"][f"{model} alone"] = alone
    for name, model, plan, optimizer, steps in SHARDED_TRAIN_RUNS:
        cfg = sharded_train_cfg(model)
        alone = ranks[0][f"{model} alone"]
        layers = kernel_layers(cfg)
        want = {"flash_attention": layers * plan.microbatches * steps * 2,
                "flash_attention_backward": layers * plan.microbatches * steps,
                "others": 0}
        got = [r[name]["launches"] for r in ranks]
        for g in got:
            launches["flash_attention"] += g["flash_attention"]
            launches["flash_attention_backward"] += g["flash_attention_backward"]
        loss_err = max(abs(a - b) / abs(b) for r in ranks for a, b in
                       zip(r[name]["losses"], alone["losses"]))
        norm_err = max(abs(a - b) / abs(b) for r in ranks for a, b in
                       zip(r[name]["grad_norms"], alone["grad_norms"]))
        rec = ranks[0][name]
        same = all(r[name]["losses"] == rec["losses"] for r in ranks)
        print(f"[sharded_train] {name} ({optimizer}, micro-batches "
              f"{plan.microbatches}, {steps} steps of {SHARDED_TRAIN_BATCH} x "
              f"{SHARDED_TRAIN_SEQ}): losses {rec['losses']} (card alone "
              f"{alone['losses']}, rel err {loss_err:.2e}); grad norms "
              f"{rec['grad_norms']} (card alone {alone['grad_norms']}, rel err "
              f"{norm_err:.2e}); tol {TOL_SHARDED_TRAIN}; step 1's gradients "
              f"of {rec['leaves']} leaves, worst {rec['grad_rel_err']:.2e} of "
              f"the leaf's largest |g| ({rec['grad_worst_leaf']}; tol "
              f"{TOL_TRAIN_GRAD}); launches a rank {got} (expected {want})",
              flush=True)
        print(f"[sharded_train] {name} step ms {['%.1f' % t for t in rec['step_ms']]}"
              f" (card alone {['%.1f' % t for t in alone['step_ms']]}); rank 0 "
              f"holds {rec['bytes'] / 1e9:.2f} GB of parameters and optimizer "
              f"state (card alone {alone['bytes'] / 1e9:.2f}), peak "
              f"{rec['peak_gib']:.1f} GiB (card alone {alone['peak_gib']:.1f}); "
              f"draw and shard {rec['draw_s']:.1f} s; rank 0's collectives "
              f"in the steps: {rec['gloo']['calls']} calls, "
              f"{rec['gloo']['s']:.2f} s in gloo", flush=True)
        print(f"[sharded_train] {name} memory a rank (GiB): peak allocated "
              f"in the steps {['%.2f' % r[name]['peak_gib'] for r in ranks]}, "
              f"reserved {['%.2f' % r[name]['reserved_gib'] for r in ranks]}, "
              f"in the step-1 gradient pass "
              f"{['%.2f' % r[name]['step1_peak_gib'] for r in ranks]}; the "
              f"card's least free memory seen by a rank "
              f"{min(r[name]['free_gib'] for r in ranks):.2f} GiB", flush=True)
        if not (loss_err <= TOL_SHARDED_TRAIN and norm_err <= TOL_SHARDED_TRAIN
                and same):
            fail(f"sharded train {name}: losses or grad norms off the card "
                 "alone's, or unequal across ranks")
        if not rec["grad_rel_err"] <= TOL_TRAIN_GRAD:
            fail(f"sharded train {name}: gradients off the card alone's")
        if any(g != want for g in got):
            fail(f"sharded train {name}: launches {got}, expected {want}")
        out["runs"][name] = {k: [r[name][k] for r in ranks] if k in
                             ("losses", "grad_norms", "launches", "step_ms",
                              "bytes", "param_bytes", "opt_bytes", "peak_gib",
                              "reserved_gib", "step1_peak_gib", "free_gib")
                             else v
                             for k, v in rec.items()} | {
            "mesh": [2, 2], "plan": asdict(plan), "optimizer": optimizer,
            "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err}
    out["launches"] = launches
    return out


# ---------------------------------------------------------------- phase 18

def request_rows(reqs) -> list:
    """Requests as [rid, tokens, true_output_len, slo, arrival] rows."""
    return [[r.rid, list(r.tokens), r.true_output_len, r.slo, r.arrival]
            for r in reqs]


def second_wave(cfg, rows: list, outputs: dict, order: list) -> list:
    """The shared-prefix run's rows: the first wave, then second-wave
    request j = first-wave request ``order[j]``'s prompt, the tokens it
    generated (``outputs``) and SHARDED_WAVE_NEW new tokens."""
    rng = np.random.default_rng(18)
    n = len(rows)
    wave = [[n + j, rows[i][1] + outputs[str(rows[i][0])]
             + rng.integers(2, cfg.vocab_size, SHARDED_WAVE_NEW).tolist(),
             rows[i][2], rows[i][3], rows[i][4]] for j, i in enumerate(order)]
    return rows + wave


def crossed_hits(rows: list, admits: list) -> list:
    """Second-wave admissions whose prefix hit reaches past their
    first-wave prompt (blocks its decode steps wrote) and whose slot is
    not the one that wrote them: (rid, source rid, source slot, slot, hit
    tokens).  At 4 slots over 4 batch shards slot s is rank s's row."""
    prompts = {r[0]: r[1] for r in rows}
    first = [r[0] for r in rows[:SHARDED_WAVE]]
    slot_of, out = {}, []
    for rid, slot, hit in admits:
        # the longest first-wave prompt this one extends
        src = max((f for f in first if rid not in first
                   and prompts[rid][:len(prompts[f])] == prompts[f]),
                  key=lambda f: len(prompts[f]), default=None)
        if src is not None and hit > len(prompts[src]) and slot_of[src] != slot:
            out.append([rid, src, slot_of[src], slot, hit])
        slot_of[rid] = slot
    return out


def paged_run(cfg, params, plan, run: str, rows: list, gloo=None) -> tuple:
    """One phase-18 run of ``PagedEngine(plan=)`` with the launch counts
    (and ``gloo``'s) set to 0 just before it and read just after: its
    outputs, counters, admissions (rid, slot, prefix tokens hit), wall,
    decode and prefill seconds; and its pools at the end."""
    reqs = [Request(rid=rid, tokens=toks, input_len=len(toks), slo=slo,
                    arrival=arr, true_output_len=out)
            for rid, toks, out, slo, arr in rows]
    eng = PagedEngine(cfg, params, PagedEngineConfig(
        **SHARDED_PAGED_PCFG, **SHARDED_PAGED_RUNS[run]), plan=plan)
    admits, states = [], []
    begin = eng._begin_prefill

    def logged(st, slot, r, outs, res):
        begin(st, slot, r, outs, res)
        admits.append([r.rid, slot, st.prefilling[slot].done])
    eng._begin_prefill = logged
    create = paged_engine.PagedDecodeState.create

    def kept(*args, **kw):
        states.append(create(*args, **kw))
        return states[-1]
    paged_engine.PagedDecodeState.create = kept
    torch.cuda.synchronize()
    reset_launches()
    if gloo is not None:
        gloo.reset()
    try:
        t0 = time.perf_counter()
        res = eng.run_continuous(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        paged_engine.PagedDecodeState.create = create
    return {"outputs": {str(k): v for k, v in res.outputs.items()},
            "steps": res.steps, "prefill_chunks": res.prefill_chunks,
            "prefix_hits": res.prefix_hits,
            "prefix_hit_tokens": res.prefix_hit_tokens,
            "drafted": res.drafted_tokens, "accepted": res.accepted_tokens,
            "admits": admits, "launches": read_launches(), "wall_s": wall,
            "decode_ms": res.decode_s * 1e3, "prefill_ms": res.prefill_s * 1e3,
            "gloo": gloo.read() if gloo is not None else None}, \
        states[-1].pools


def pool_error(pools: list, ref: dict) -> float:
    """The largest difference of ``pools`` from the card alone's (``ref``,
    by "layer/k"), on every page but the null one, over its largest
    value."""
    err = scale = 0.0
    for i, pool in enumerate(pools):
        for n in ("k", "v"):
            want = ref[f"{i}/{n}"].to(pool[n].device)[1:]
            err = max(err, (pool[n][1:] - want).abs().max().item())
            scale = max(scale, want.abs().max().item())
    return err / scale


def sharded_paged_rank(rank: int, out_dir: str) -> None:
    """One of phase 18's ranks on the card: its full weights drawn in turn
    (each rank holds a whole replica under dp), then every run of
    SHARDED_PAGED_RUNS on the card alone's requests through
    ``PagedEngine(plan=dp)``, after a warm-up on the first four serve
    requests; each run's pools held to the card alone's.  Writes its
    records, with the K1 and K2 shapes it called."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(out_dir)
    rows = json.loads((out / "rows.json").read_text())
    cfg = sharded_cfg("chatglm2", CHATGLM2_LAYERS)
    mesh = Mesh({"data": 2, "model": 2}, device="cuda")
    gloo, flash, paged = GlooClock(), FlashShapes(), PagedShapes()
    dec = DecodeShapes()
    recs = {}
    with set_mesh(mesh):
        t0 = time.perf_counter()
        for turn in range(dist.get_world_size()):
            if turn == rank:
                params = sharded_draw(cfg)
                shard_params(cfg, params, SHARDED_PAGED_PLAN)
                torch.cuda.empty_cache()
            dist.barrier()
        recs["draw_s"] = time.perf_counter() - t0
        paged_run(cfg, params, SHARDED_PAGED_PLAN, "serve", rows["serve"][:4])
        torch.cuda.reset_peak_memory_stats()
        for run in SHARDED_PAGED_RUNS:
            rec, pools = paged_run(cfg, params, SHARDED_PAGED_PLAN, run,
                                   rows[run], gloo)
            rec["pool_err"] = pool_error(pools, torch.load(
                out / f"pools_{run}.pt", map_location="cuda"))
            recs[run] = rec
            del pools
        recs["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del params
        torch.cuda.empty_cache()
    recs["shapes"] = {"calls": flash.read()["calls"], "paged": paged.read(),
                      "decode": dec.read()}
    (out / f"rank{rank}.json").write_text(json.dumps(recs))


def phase_sharded_paged() -> dict:
    """The paged engine under dp: chatglm2-6b served on the card alone,
    then by 4 ranks sharing it over gloo (SHARDED_PAGED_RUNS): every run's
    tokens equal to the card alone's, every rank's pools within TOL_POOL of
    the card alone's, K1 on each rank layers x steps and K2 layers x
    prefill chunks, gloo calls a step layers + 1 (one K/V all-gather a
    layer, the logits' gather), a second-wave prefix hit on a slot of
    another rank than the one that decoded its blocks, and every K1 and K2
    shape a rank called a parity case; decode-step wall time beside the
    card alone's."""
    out_dir = ROOT / "build" / "sharded_paged"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    cfg = sharded_cfg("chatglm2", CHATGLM2_LAYERS)
    layers = kernel_layers(cfg)
    params = sharded_draw(cfg)
    rows = {"serve": request_rows(serve.make_requests(cfg, 12, 16))}
    rows["spec"] = rows["serve"]
    first = request_rows(serve.make_requests(cfg, SHARDED_WAVE, 16,
                                             "shared-prefix"))
    paged_run(cfg, params, None, "serve", rows["serve"][:4])     # warm-up
    wave1 = paged_run(cfg, params, None, "waves", first)[0]["outputs"]
    # the second wave's order: the first of these whose run has a hit on a
    # slot that did not decode the blocks it hits
    for shift in range(SHARDED_WAVE):
        order = [(SHARDED_WAVE - 1 - j + shift) % SHARDED_WAVE
                 for j in range(SHARDED_WAVE)]
        rows["waves"] = second_wave(cfg, first, wave1, order)
        probe = paged_run(cfg, params, None, "waves", rows["waves"])[0]
        if crossed_hits(rows["waves"], probe["admits"]):
            break
    else:
        fail("sharded paged: no second-wave order hits another slot's "
             "decoded blocks")
    (out_dir / "rows.json").write_text(json.dumps(rows))
    alone, launches = {}, {k: 0 for k in TIMED}
    for run in SHARDED_PAGED_RUNS:
        alone[run], pools = paged_run(cfg, params, None, run, rows[run])
        torch.save({f"{i}/{n}": p[n].cpu() for i, p in enumerate(pools)
                    for n in ("k", "v")}, out_dir / f"pools_{run}.pt")
        for k in launches:
            launches[k] += alone[run]["launches"][k]
        del pools
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_ranks(sharded_paged_rank, (str(out_dir),), world=SHARDED_WORLD,
              timeout=300.0, join_timeout=600.0)
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(SHARDED_WORLD)]
    print(f"[sharded_paged] {SHARDED_WORLD} ranks on one card over gloo "
          f"under dp {{data: 2, model: 2}}: {ranks_s:.1f} s from spawn to "
          f"join; each drew a whole replica of {layers} layers in "
          f"{ranks[0]['draw_s']:.1f} s; peak "
          f"{max(r['peak_gib'] for r in ranks):.1f} GiB a rank", flush=True)
    out = {"ranks_s": ranks_s, "runs": {}, "shapes": shape_coverage(
        "sharded_paged", [r["shapes"] for r in ranks], need_grad=False)}
    for run in SHARDED_PAGED_RUNS:
        ref = alone[run]
        rec = ranks[0][run]
        same, total = agreement(rec["outputs"], ref["outputs"])
        want = {"flash_attention": layers * ref["prefill_chunks"],
                "decode_attention": 0,
                "paged_attention": layers * ref["steps"], "wkv6": 0}
        got = [r[run]["launches"] for r in ranks]
        for r in ranks:
            for k in launches:
                launches[k] += r[run]["launches"][k]
        calls = [r[run]["gloo"]["calls"] for r in ranks]
        errs = [r[run]["pool_err"] for r in ranks]
        crossed = crossed_hits(rows[run], rec["admits"]) if run == "waves" \
            else []
        step_ms = rec["decode_ms"] / rec["steps"]
        ref_ms = ref["decode_ms"] / ref["steps"]
        print(f"[sharded_paged] {run}: {len(rows[run])} requests, tokens "
              f"{same}/{total} equal to the card alone's; pools max err "
              f"{max(errs):.3e} of the largest value (tol {TOL_POOL}); "
              f"launches a rank {got} (expected {want}); {rec['steps']} "
              f"steps, {rec['prefill_chunks']} prefill chunks, prefix hits "
              f"{rec['prefix_hits']} ({rec['prefix_hit_tokens']} tokens), "
              f"accepted {rec['accepted']} of {rec['drafted']} drafts; "
              f"second-wave hits on another rank's decoded blocks "
              f"{crossed}", flush=True)
        print(f"[sharded_paged] {run}: decode {step_ms:.2f} ms a step (card "
              f"alone {ref_ms:.2f}); wall {rec['wall_s']:.2f} s (card alone "
              f"{ref['wall_s']:.2f}); rank 0's collectives {calls[0]} calls, "
              f"{calls[0] / rec['steps']:.1f} a step (expected {layers + 1}), "
              f"{rec['gloo']['s']:.3f} s in gloo", flush=True)
        if same != total or any(r[run]["outputs"] != ref["outputs"]
                                for r in ranks):
            fail(f"sharded paged {run}: {same}/{total} tokens equal the "
                 "card alone's")
        if any(r[run]["admits"] != ref["admits"] for r in ranks):
            fail(f"sharded paged {run}: admissions differ from the card "
                 "alone's")
        if not max(errs) <= TOL_POOL:
            fail(f"sharded paged {run}: pools off the card alone's by {errs}")
        if any(g != want for g in got) or min(
                want[k] for k in ("flash_attention", "paged_attention")) <= 0:
            fail(f"sharded paged {run}: launches {got}, expected {want}")
        if any(c != rec["steps"] * (layers + 1) for c in calls):
            fail(f"sharded paged {run}: gloo calls {calls}, expected "
                 f"{layers + 1} a step")
        if run == "waves" and not crossed:
            fail("sharded paged: no second-wave hit on another rank's "
                 "decoded blocks")
        out["runs"][run] = {
            "requests": len(rows[run]), "tokens_equal": [same, total],
            "pool_err": errs, "launches_per_rank": got,
            "steps": rec["steps"], "prefill_chunks": rec["prefill_chunks"],
            "prefix_hits": rec["prefix_hits"],
            "prefix_hit_tokens": rec["prefix_hit_tokens"],
            "drafted": rec["drafted"], "accepted": rec["accepted"],
            "crossed_hits": crossed, "decode_ms_per_step": step_ms,
            "one_card_decode_ms_per_step": ref_ms,
            "wall_s": [r[run]["wall_s"] for r in ranks],
            "one_card_wall_s": ref["wall_s"],
            "gloo": [r[run]["gloo"] for r in ranks]}
    out["launches"] = launches
    return out


# ---------------------------------------------------------------- phase 19

def recurrent_cfg(model: str):
    """Phase 19's configs (SHARDED_RECURRENT): full width, cut depth."""
    arch, layers = SHARDED_RECURRENT[model]
    return replace(get_config(arch), n_layers=layers)


def recurrent_gloo_calls(cfg) -> int:
    """The collectives of one decode step of ``cfg`` under tp_dp on
    {data: 2, model: 2}: the vocab-parallel embedding's psum, the logits'
    gathers over model and then data, and a layer's: an RWKV-6 layer's
    psum of ``o``, all-gather of the state and psum of the channel mix's
    ``value``; a Mamba layer's all-gather of in_proj's columns, psum of
    B, C and dt, psum of ``out_proj`` and all-gather of the ssm state,
    and its dense MLP's psum."""
    per_layer = {"rwkv6": 3, "mamba": 5}
    return 3 + sum(per_layer[sp.mixer] for sp in cfg.layer_plan())


def recurrent_serve(cfg, params, plan, clock=None) -> dict:
    """Serve phase 19's requests on ``params``: one card's model (``plan``
    None) or this rank's slices under ``plan``.  First the first batch's
    prefill and first decode-step logits, that step's collectives counted
    by ``clock``; then, with the launch counts set to 0 just before and
    read just after, the 12 serve requests in batches of 4 padded and then
    continuously (4 slots), each prefill's row lengths logged (the
    admissions)."""
    ecfg = EngineConfig(max_batch=4, cache_len=SHARDED_CACHE, max_new_tokens=16)
    eng = InferenceEngine(cfg, params, ecfg, plan=plan)
    batches = sharded_batches(cfg, False)
    toks, kv_len = eng._pad_prompts([r.tokens for r in batches[0].requests])
    lg, cache = eng._prefill(toks, kv_len)
    torch.cuda.synchronize()
    if clock is not None:
        clock.reset()
    lg2, _ = eng._decode(greedy(lg, cfg.vocab_size)[:, None].long(), cache,
                         kv_len)
    step_calls = clock.read()["calls"] if clock is not None else None
    logits = torch.stack([lg, lg2]).float().cpu().numpy()
    del cache, lg, lg2
    waves, prefill = [], eng._prefill

    def logged(toks, kv_len):
        waves.append(kv_len.tolist())
        return prefill(toks, kv_len)
    eng._prefill = logged
    true = {r.rid: r.true_output_len for b in batches for r in b.requests}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    if clock is not None:
        clock.reset()
    outs, runs = {}, []
    for b in batches:
        res = eng.run_batch(b, true_lens=true)
        outs.update(res.outputs)
        runs.append({"prefill_ms": res.prefill_s * 1e3,
                     "decode_ms": res.decode_s * 1e3, "steps": res.steps})
    t0 = time.perf_counter()
    cont = eng.run_continuous([r for b in batches for r in b.requests])
    torch.cuda.synchronize()
    cont_s = time.perf_counter() - t0
    del eng._prefill        # the wrapper's cycle would keep the weights alive
    return {"outputs": {str(k): v for k, v in outs.items()},
            "continuous": {str(k): v for k, v in cont.outputs.items()},
            "continuous_s": cont_s, "continuous_steps": cont.steps,
            "waves": waves, "logits": logits, "launches": read_launches(),
            "batches": runs, "step_calls": step_calls,
            "gloo": clock.read() if clock is not None else None,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def sharded_recurrent_rank(rank: int, out_dir: str) -> None:
    """One of phase 19's ranks on the card: each model of
    SHARDED_RECURRENT drawn in turn (one full copy on the card at a time)
    and cut to this rank's slices, then served under tp_dp.  Writes its
    records, with the K4 shapes it called, and on rank 0 the logits."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(out_dir)
    gloo, wkv, dec = GlooClock(), WKV6Shapes(), DecodeShapes()
    recs = {}
    with set_mesh(Mesh({"data": 2, "model": 2}, device="cuda")):
        for model in SHARDED_RECURRENT:
            cfg = recurrent_cfg(model)
            t0 = time.perf_counter()
            for turn in range(dist.get_world_size()):
                if turn == rank:
                    params = sharded_draw(cfg)
                    shard_params(cfg, params, SHARDED_RECURRENT_PLAN)
                    torch.cuda.empty_cache()
                dist.barrier()
            draw_s = time.perf_counter() - t0
            held = torch.cuda.memory_allocated() / 2**30
            param_bytes = tensor_bytes(params.parameters())
            rec = recurrent_serve(cfg, params, SHARDED_RECURRENT_PLAN, gloo)
            del params
            torch.cuda.empty_cache()
            if rank == 0:
                np.save(out / f"{model}.npy", rec["logits"])
            recs[model] = {k: v for k, v in rec.items() if k != "logits"} | {
                "draw_s": draw_s, "held_gib": held, "param_bytes": param_bytes}
    recs["shapes"] = {"wkv6": wkv.read(), "decode": dec.read()}
    (out / f"rank{rank}.json").write_text(json.dumps(recs))


def phase_sharded_recurrent() -> dict:
    """Mamba and RWKV-6 blocks under tp_dp (SHARDED_RECURRENT): each model
    served on the card alone, which is then freed, and by 4 ranks sharing
    it over gloo: tokens (padded and continuous) and admissions equal to
    the card alone's, logits within TOL_LOGITS, K4 on each rank layers x
    prefills at half the heads (every shape a parity case), no attention
    kernel, the collectives of a decode step; step times beside the card
    alone's."""
    out_dir = ROOT / "build" / "sharded_recurrent"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    alone, launches = {}, {k: 0 for k in TIMED}
    for model in SHARDED_RECURRENT:
        cfg = recurrent_cfg(model)
        t0 = time.perf_counter()
        params = sharded_draw(cfg)
        draw_s = time.perf_counter() - t0
        alone[model] = recurrent_serve(cfg, params, None)
        alone[model]["draw_s"] = draw_s
        alone[model]["weight_gib"] = sum(
            p.numel() * p.element_size() for p in params.parameters()) / 2**30
        for k in launches:
            launches[k] += alone[model]["launches"][k]
        del params
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_ranks(sharded_recurrent_rank, (str(out_dir),), world=SHARDED_WORLD,
              timeout=300.0, join_timeout=600.0)
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(SHARDED_WORLD)]
    print(f"[sharded_recurrent] {SHARDED_WORLD} ranks on one card over gloo "
          f"under tp_dp {{data: 2, model: 2}}: {ranks_s:.1f} s from spawn to "
          "join", flush=True)
    out = {"ranks_s": ranks_s, "runs": {}, "shapes": shape_coverage(
        "sharded_recurrent", [r["shapes"] for r in ranks], need_grad=False)}
    for model in SHARDED_RECURRENT:
        cfg, ref = recurrent_cfg(model), alone[model]
        rec = ranks[0][model]
        same, total = agreement(rec["outputs"], ref["outputs"])
        c_same, c_total = agreement(rec["continuous"], ref["continuous"])
        err = float(np.abs(np.load(out_dir / f"{model}.npy")
                           - ref["logits"]).max())
        prefills = len(ref["waves"])
        rwkv_layers = sum(sp.mixer == "rwkv6" for sp in cfg.layer_plan())
        want = {"flash_attention": 0, "decode_attention": 0,
                "paged_attention": 0, "wkv6": rwkv_layers * prefills}
        got = [r[model]["launches"] for r in ranks]
        for r in ranks:
            for k in launches:
                launches[k] += r[model]["launches"][k]
        heads = sorted({row[2] for r in ranks for row in r["shapes"]["wkv6"]})
        calls = [r[model]["step_calls"] for r in ranks]
        want_calls = recurrent_gloo_calls(cfg)
        steps = sum(b["steps"] for b in rec["batches"])
        step_ms = sum(b["decode_ms"] for b in rec["batches"]) / steps
        ref_ms = sum(b["decode_ms"] for b in ref["batches"]) / steps
        run_s = sum(b["prefill_ms"] + b["decode_ms"]
                    for b in rec["batches"]) / 1e3 + rec["continuous_s"]
        print(f"[sharded_recurrent] {model} ({cfg.name}, {cfg.n_layers} of "
              f"{get_config(cfg.name).n_layers} layers, "
              f"{ref['weight_gib']:.2f} GiB of f32 weights, drawn on the "
              f"card alone in {ref['draw_s']:.1f} s): tokens {same}/{total} "
              f"padded and {c_same}/{c_total} continuous equal to the card "
              f"alone's; admissions {len(rec['waves'])} prefills, equal "
              f"{all(r[model]['waves'] == ref['waves'] for r in ranks)}; "
              f"logits max_abs_err {err:.3e} (tol {TOL_LOGITS}); launches a "
              f"rank {got} (expected {want}); K4 heads a call {heads}",
              flush=True)
        print(f"[sharded_recurrent] {model}: decode {step_ms:.2f} ms a step "
              f"(card alone {ref_ms:.2f}), {calls[0]} gloo calls a step "
              f"(expected {want_calls}); continuous {rec['continuous_s']:.2f} "
              f"s (card alone {ref['continuous_s']:.2f}); rank 0's "
              f"collectives {rec['gloo']['calls']} calls, "
              f"{rec['gloo']['s']:.2f} s in gloo of the runs' {run_s:.2f} s; "
              f"draw and shard {rec['draw_s']:.1f} s; held "
              f"{[round(r[model]['held_gib'], 2) for r in ranks]} GiB and "
              f"peak {[round(r[model]['peak_gib'], 2) for r in ranks]} GiB "
              f"a rank (card alone peak {ref['peak_gib']:.2f})", flush=True)
        if same != total or c_same != c_total or any(
                r[model]["outputs"] != ref["outputs"]
                or r[model]["continuous"] != ref["continuous"] for r in ranks):
            fail(f"sharded recurrent {model}: tokens {same}/{total}, "
                 f"{c_same}/{c_total} equal the card alone's")
        if any(r[model]["waves"] != ref["waves"] for r in ranks):
            fail(f"sharded recurrent {model}: admissions differ from the "
                 "card alone's")
        if not err <= TOL_LOGITS:
            fail(f"sharded recurrent {model}: logits differ from the card "
                 f"alone's by {err}")
        if any(g != want for g in got):
            fail(f"sharded recurrent {model}: launches {got}, expected {want}")
        if any(c != want_calls for c in calls):
            fail(f"sharded recurrent {model}: gloo calls a step {calls}, "
                 f"expected {want_calls}")
        out["runs"][model] = {
            "arch": cfg.name, "layers": cfg.n_layers,
            "weight_gib": ref["weight_gib"], "tokens_equal": [same, total],
            "continuous_equal": [c_same, c_total], "waves": ref["waves"],
            "logits_max_abs_err": err, "launches_per_rank": got,
            "gloo_calls_per_step": calls, "decode_ms_per_step": step_ms,
            "one_card_decode_ms_per_step": ref_ms,
            "continuous_s": rec["continuous_s"],
            "one_card_continuous_s": ref["continuous_s"],
            "batches": rec["batches"], "one_card_batches": ref["batches"],
            "gloo_rank0": rec["gloo"], "draw_s": rec["draw_s"],
            "held_gib": [r[model]["held_gib"] for r in ranks],
            "peak_gib": [r[model]["peak_gib"] for r in ranks],
            "param_bytes": [r[model]["param_bytes"] for r in ranks],
            "one_card_peak_gib": ref["peak_gib"]}
    heads = {row[2] for r in ranks for row in r["shapes"]["wkv6"]}
    want_heads = recurrent_cfg("rwkv6").n_heads // 2
    if heads != {want_heads}:
        fail(f"sharded recurrent: K4 ran at {sorted(heads)} heads, expected "
             f"{want_heads} on every rank")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------- phase 20

def encdec_serve(cfg, params, plan, clock=None) -> dict:
    """Serve phase 20's whisper batches on ``params``: one card's model
    (``plan`` None) or this rank's slices under ``plan``.  First each of
    WHISPER_BATCHES' prefill and first decode-step logits (a warm-up too),
    the short batch's step's collectives counted by ``clock``; then each
    batch through ``encdec_greedy``."""
    frames, batches = whisper_inputs(cfg)
    logits, step_calls = [], None
    for toks, kv_len, _, cache_len in batches.values():
        lg, cache = api.prefill(cfg, params, {"frames": frames,
                                              "tokens": toks},
                                cache_len=cache_len, kv_len=kv_len, plan=plan)
        nxt = greedy(lg, cfg.vocab_size)[:, None].long()
        torch.cuda.synchronize()
        if clock is not None:
            clock.reset()
        lg2, _ = api.decode_step(cfg, params, nxt, cache, kv_len, plan=plan)
        torch.cuda.synchronize()
        if clock is not None and step_calls is None:
            step_calls = clock.read()["calls"]
        logits += [lg.float().cpu().numpy(), lg2.float().cpu().numpy()]
        del cache, lg, lg2
    logits = np.stack(logits)
    torch.cuda.reset_peak_memory_stats()
    if clock is not None:
        clock.reset()
    runs = {what: encdec_greedy(cfg, params, frames, toks, kv_len, n_new,
                                cache_len, plan)
            for what, (toks, kv_len, n_new, cache_len) in batches.items()}
    return {"logits": logits, "step_calls": step_calls, "runs": runs,
            "gloo": clock.read() if clock is not None else None,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def encdec_train_cfg():
    """Phase 20's training config: whisper-medium at full width and
    SHARDED_ENCDEC_TRAIN_LAYERS encoder and decoder layers."""
    return replace(get_config("whisper-medium"),
                   n_layers=SHARDED_ENCDEC_TRAIN_LAYERS,
                   n_encoder_layers=SHARDED_ENCDEC_TRAIN_LAYERS)


def encdec_train_batch(cfg, i: int) -> dict:
    """Step i's seeded batch on the card: 4 x SHARDED_ENCDEC_TRAIN_SEQ
    tokens, their next tokens as labels, and frames [4, 1,536, d] x
    0.02."""
    rng = np.random.default_rng(20 + i)
    toks = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (4, SHARDED_ENCDEC_TRAIN_SEQ + 1))).cuda()
    frames = torch.from_numpy((rng.standard_normal(
        (4, WHISPER_FRAMES, cfg.d_model)) * 0.02).astype(np.float32)).cuda()
    return {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def sharded_encdec_rank(rank: int, out_dir: str) -> None:
    """One of phase 20's ranks on the card: whisper-medium drawn in turn
    (one full copy on the card at a time) and cut to this rank's slices,
    served under tp_dp (``encdec_serve``); then its 2 + 2-layer cut drawn
    in turn and trained under tp_dp_train, step 1's gradients held, slice
    by slice, to the card alone's (``alone_grads.pt``).  Writes its
    records, with the K2 and K3 shapes it called, and on rank 0 the
    logits."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(out_dir)
    gloo, flash, dec = GlooClock(), FlashShapes(), DecodeShapes()
    recs = {}

    def drawn(cfg, plan):
        for turn in range(dist.get_world_size()):
            if turn == rank:
                params = sharded_draw(cfg)
                shard_params(cfg, params, plan)
                torch.cuda.empty_cache()
            dist.barrier()
        return params
    with set_mesh(Mesh({"data": 2, "model": 2}, device="cuda")):
        cfg = get_config("whisper-medium")
        t0 = time.perf_counter()
        params = drawn(cfg, SHARDED_ENCDEC_PLAN)
        draw_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated() / 2**30
        param_bytes = tensor_bytes(params.parameters())
        rec = encdec_serve(cfg, params, SHARDED_ENCDEC_PLAN, gloo)
        del params
        torch.cuda.empty_cache()
        if rank == 0:
            np.save(out / "logits.npy", rec["logits"])
        recs["serve"] = {k: v for k, v in rec.items() if k != "logits"} | {
            "draw_s": draw_s, "held_gib": held, "param_bytes": param_bytes}
        cfg = encdec_train_cfg()
        plan = SHARDED_ENCDEC_TRAIN_PLAN
        params = drawn(cfg, plan).requires_grad_(True)
        specs = {k: p.shard_spec for k, p in params.named_parameters()}
        ref = torch.load(out / "alone_grads.pt")
        worst = {}

        def compare(grads):
            for k, g in grads.items():
                want = shard_tensor(ref[k].to(g.device), specs[k])
                err = (g - want).abs().max().item()
                scale = ref[k].abs().max().item()
                worst[k] = (err / (TOL_TRAIN_GRAD * scale + GRAD_FLOOR), err,
                            scale)
                del want
        tcfg = TrainConfig(opt=OptConfig(kind="adamw"),
                           microbatches=plan.microbatches)
        rec = sharded_train_run(cfg, params, plan, tcfg,
                                SHARDED_ENCDEC_TRAIN_STEPS, gloo, compare,
                                batch_at=lambda i: encdec_train_batch(cfg, i))
        del params, ref
        torch.cuda.empty_cache()
        leaf = max(worst, key=lambda k: worst[k][0])
        recs["train"] = rec | {"grad_leaves": len(worst), "grad_worst_leaf":
                               leaf, "grad_worst": list(worst[leaf])}
    recs["shapes"] = flash.read() | {"decode": dec.read()}
    (out / f"rank{rank}.json").write_text(json.dumps(recs))


def phase_sharded_encdec() -> dict:
    """whisper-medium under a plan: served at full width and depth under
    tp_dp and trained at 2 + 2 layers under tp_dp_train, each on the card
    alone, which is then freed, and by 4 ranks sharing it over gloo:
    greedy tokens equal to the card alone's and both batches' prefill and
    first-step logits within TOL_LOGITS, K2 and K3 launches a rank as on
    the card alone, every call on 8 of the 16 heads, every shape of the
    ranks and of the card alone a parity case, gloo calls of a decode step;
    train losses and grad norms within TOL_SHARDED_TRAIN, step 1's
    gradients within TOL_TRAIN_GRAD of each leaf's largest (GRAD_FLOOR
    beside it), K2's forward and gradient a layer call each step; step
    times beside the card alone's, each rank's peak memory."""
    out_dir = ROOT / "build" / "sharded_encdec"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    cfg, train_cfg = get_config("whisper-medium"), encdec_train_cfg()
    launches = {k: 0 for k in TIMED} | {"flash_attention_backward": 0}
    flash, dec = FlashShapes(), DecodeShapes()
    try:
        t0 = time.perf_counter()
        params = sharded_draw(cfg)
        draw_s = time.perf_counter() - t0
        alone = encdec_serve(cfg, params, None)
        del params
        torch.cuda.empty_cache()
        params = sharded_draw(train_cfg).requires_grad_(True)
        tcfg = TrainConfig(opt=OptConfig(kind="adamw"))
        alone_train = sharded_train_run(
            train_cfg, params, None, tcfg, SHARDED_ENCDEC_TRAIN_STEPS, None,
            lambda grads: torch.save({k: g.cpu() for k, g in grads.items()},
                                     out_dir / "alone_grads.pt"),
            batch_at=lambda i: encdec_train_batch(train_cfg, i))
        del params
        torch.cuda.empty_cache()
    finally:
        flash.close()
        dec.close()
    alone_shapes = flash.read() | {"decode": dec.read()}
    for part in [r["launches"] for r in alone["runs"].values()]:
        for p in part:
            for k in TIMED:
                launches[k] += p[k]
    launches["flash_attention"] += alone_train["launches"]["flash_attention"]
    launches["flash_attention_backward"] += \
        alone_train["launches"]["flash_attention_backward"]
    t0 = time.perf_counter()
    run_ranks(sharded_encdec_rank, (str(out_dir),), world=SHARDED_WORLD,
              timeout=300.0, join_timeout=600.0)
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(SHARDED_WORLD)]
    print(f"[sharded_encdec] {SHARDED_WORLD} ranks on one card over gloo on "
          f"{{data: 2, model: 2}}: {ranks_s:.1f} s from spawn to join",
          flush=True)
    out = {"ranks_s": ranks_s, "alone_draw_s": draw_s, "runs": {},
           "shapes": shape_coverage("sharded_encdec",
                                    [r["shapes"] for r in ranks]),
           "alone_shapes": shape_coverage("sharded_encdec card alone",
                                          [alone_shapes])}
    heads = cfg.n_heads // 2
    seen_heads = {row[3] for r in ranks for row in r["shapes"]["calls"]} | {
        row[2] for r in ranks for row in r["shapes"]["decode"]}
    if seen_heads != {heads}:
        fail(f"sharded encdec: K2/K3 ran at {sorted(seen_heads)} heads, "
             f"expected {heads} on every rank")
    # serve
    err = float(np.abs(np.load(out_dir / "logits.npy")
                       - alone["logits"]).max())
    want_calls = 3 * cfg.n_layers + 3
    calls = [r["serve"]["step_calls"] for r in ranks]
    print(f"[sharded_encdec] serve whisper-medium ({cfg.n_encoder_layers} + "
          f"{cfg.n_layers} layers) under tp_dp: both batches' prefill and "
          f"first-step logits max_abs_err "
          f"{err:.3e} (tol {TOL_LOGITS}); {calls[0]} gloo calls a decode "
          f"step (expected {want_calls}); slices held "
          f"{[round(r['serve']['held_gib'], 2) for r in ranks]} GiB and peak "
          f"{[round(r['serve']['peak_gib'], 2) for r in ranks]} GiB a rank "
          f"(card alone peak {alone['peak_gib']:.2f}); draw and shard "
          f"{ranks[0]['serve']['draw_s']:.1f} s (card alone {draw_s:.1f})",
          flush=True)
    bad = []
    if not err <= TOL_LOGITS:
        bad.append(f"logits {err}")
    if any(c != want_calls for c in calls):
        bad.append(f"gloo calls a step {calls}, expected {want_calls}")
    for what, lengths, n_new, cache_len in WHISPER_BATCHES:
        ref = alone["runs"][what]
        want_l, want_shapes = encdec_expected(cfg, len(lengths), cache_len,
                                              n_new, rows=2, heads=2)
        got = [r["serve"]["runs"][what] for r in ranks]
        same, total = agreement(got[0]["outputs"], ref["outputs"])
        step_ms = got[0]["decode_s"] * 1e3 / n_new
        ref_ms = ref["decode_s"] * 1e3 / n_new
        print(f"[sharded_encdec] {what} {lengths}: tokens {same}/{total} "
              f"equal to the card alone's; launches a rank "
              f"{[g['launches'] for g in got][0]} (expected {want_l}, card "
              f"alone {ref['launches']}); prefill "
              f"{got[0]['prefill_s'] * 1e3:.1f} ms (card alone "
              f"{ref['prefill_s'] * 1e3:.1f}); decode {step_ms:.2f} ms a "
              f"step with {calls[0]} gloo calls (card alone {ref_ms:.2f}); "
              f"cache a rank {got[0]['cache_shapes']}", flush=True)
        if any(g["outputs"] != ref["outputs"] for g in got) or same != total:
            bad.append(f"{what} tokens {same}/{total}")
        if any(g["launches"] != want_l for g in got) \
                or ref["launches"] != encdec_expected(
                    cfg, len(lengths), cache_len, n_new)[0]:
            bad.append(f"{what} launches")
        if any(g["cache_shapes"] != want_shapes or not g["finite"]
               or g["cache_layers"] != cfg.n_layers for g in got):
            bad.append(f"{what} caches or finite logits")
        for g in got:
            for p in g["launches"]:
                for k in TIMED:
                    launches[k] += p[k]
        out["runs"][what] = {
            "tokens_equal": [same, total], "launches_per_rank":
            [g["launches"] for g in got], "one_card_launches": ref["launches"],
            "prefill_ms": [g["prefill_s"] * 1e3 for g in got],
            "one_card_prefill_ms": ref["prefill_s"] * 1e3,
            "decode_ms_per_step": [g["decode_s"] * 1e3 / n_new for g in got],
            "one_card_decode_ms_per_step": ref_ms,
            "cache_shapes_per_rank": got[0]["cache_shapes"]}
    out["serve"] = {"logits_max_abs_err": err, "gloo_calls_per_step": calls,
                    "gloo_rank0": ranks[0]["serve"]["gloo"],
                    "held_gib": [r["serve"]["held_gib"] for r in ranks],
                    "peak_gib": [r["serve"]["peak_gib"] for r in ranks],
                    "param_bytes": [r["serve"]["param_bytes"] for r in ranks],
                    "one_card_peak_gib": alone["peak_gib"]}
    # train
    layers = train_cfg.n_encoder_layers + 2 * train_cfg.n_layers
    steps = SHARDED_ENCDEC_TRAIN_STEPS
    want = {"flash_attention": layers * steps,
            "flash_attention_backward": layers * steps, "others": 0}
    got = [r["train"]["launches"] for r in ranks]
    for g in got:
        launches["flash_attention"] += g["flash_attention"]
        launches["flash_attention_backward"] += g["flash_attention_backward"]
    loss_err = max(abs(a - b) / abs(b) for r in ranks for a, b in
                   zip(r["train"]["losses"], alone_train["losses"]))
    norm_err = max(abs(a - b) / abs(b) for r in ranks for a, b in
                   zip(r["train"]["grad_norms"], alone_train["grad_norms"]))
    worst = max((r["train"]["grad_worst"] + [r["train"]["grad_worst_leaf"]]
                 for r in ranks), key=lambda w: w[0])
    rec = ranks[0]["train"]
    print(f"[sharded_encdec] train whisper-medium ({train_cfg.n_encoder_layers}"
          f" + {train_cfg.n_layers} layers, AdamW, {steps} steps of 4 x "
          f"{SHARDED_ENCDEC_TRAIN_SEQ} tokens over 4 x {WHISPER_FRAMES} "
          f"frames) under tp_dp_train: losses {rec['losses']} (card alone "
          f"{alone_train['losses']}, rel err {loss_err:.2e}); grad norms rel "
          f"err {norm_err:.2e}; tol {TOL_SHARDED_TRAIN}; step 1's gradients "
          f"of {rec['grad_leaves']} leaves, worst {worst[1]:.3e} of the "
          f"leaf's largest |g| {worst[2]:.3e} ({worst[3]}; {worst[0]:.3f} of "
          f"its tolerance {TOL_TRAIN_GRAD} x largest + {GRAD_FLOOR}); "
          f"launches a rank {got} (expected {want})", flush=True)
    print(f"[sharded_encdec] train step ms "
          f"{['%.1f' % t for t in rec['step_ms']]} (card alone "
          f"{['%.1f' % t for t in alone_train['step_ms']]}); rank 0's "
          f"collectives {rec['gloo']['calls']} calls, "
          f"{rec['gloo']['s']:.2f} s in gloo; peak "
          f"{[round(r['train']['peak_gib'], 2) for r in ranks]} GiB a rank "
          f"(card alone {alone_train['peak_gib']:.2f})", flush=True)
    if not (loss_err <= TOL_SHARDED_TRAIN and norm_err <= TOL_SHARDED_TRAIN):
        bad.append("train losses or grad norms")
    if not worst[0] <= 1.0:
        bad.append(f"train gradient {worst}")
    if any(g != want for g in got):
        bad.append(f"train launches {got}, expected {want}")
    if bad:
        fail(f"sharded encdec: {bad}")
    out["train"] = {k: [r["train"][k] for r in ranks] for k in (
        "losses", "grad_norms", "launches", "step_ms", "peak_gib",
        "param_bytes", "opt_bytes", "grad_worst", "grad_worst_leaf")} | {
        "one_card": alone_train, "loss_rel_err": loss_err,
        "grad_norm_rel_err": norm_err, "gloo_rank0": rec["gloo"],
        "plan": asdict(SHARDED_ENCDEC_TRAIN_PLAN)}
    out["launches"] = launches
    return out


# ---------------------------------------------------------------- phase 21

def dryrun_mirrors() -> dict:
    """Phases 17, 19 and 20's runs as dry-run cells on {data: 2, model: 2}
    in f32: name -> (config, shape, plan, optimizer).  Phase 17's train
    steps of SHARDED_TRAIN_BATCH x SHARDED_TRAIN_SEQ; phase 19's decode of
    4 rows over a cache of SHARDED_CACHE; phase 20's prefill of 4 rows
    (1,536 frames, 192 prompt tokens: the K2 calls do not depend on the
    lengths), the short batch's decode step, and its train step (the
    reference's train input specs give 64 frames a row where phase 20
    feeds 1,536, so that cell's peak is not like for like)."""
    out = {}
    for name, model, plan, optimizer, _ in SHARDED_TRAIN_RUNS:
        out[f"sharded_train/{name}"] = (
            sharded_train_cfg(model),
            ShapeConfig("phase17_train", SHARDED_TRAIN_SEQ,
                        SHARDED_TRAIN_BATCH, "train"), plan, optimizer)
    for model in SHARDED_RECURRENT:
        out[f"sharded_recurrent/{model}"] = (
            recurrent_cfg(model),
            ShapeConfig("phase19_decode", SHARDED_CACHE, 4, "decode"),
            SHARDED_RECURRENT_PLAN, "adamw")
    cfg = get_config("whisper-medium")
    _, lengths, _, cache_len = WHISPER_BATCHES[0]
    out["sharded_encdec/prefill"] = (
        cfg, ShapeConfig("phase20_prefill", WHISPER_FRAMES, len(lengths),
                         "prefill"), SHARDED_ENCDEC_PLAN, "adamw")
    out["sharded_encdec/decode"] = (
        cfg, ShapeConfig("phase20_decode", cache_len, len(lengths), "decode"),
        SHARDED_ENCDEC_PLAN, "adamw")
    out["sharded_encdec/train"] = (
        encdec_train_cfg(), ShapeConfig("phase20_train",
                                        SHARDED_ENCDEC_TRAIN_SEQ, 4, "train"),
        SHARDED_ENCDEC_TRAIN_PLAN, "adamw")
    return out


def dryrun_tasks() -> list:
    """The dry-run subprocess's tasks, the longest first: each (a) cell's
    rank 0 and last rank apart (train cells first), the hillclimb's three
    climbs, and each (b) cell's four ranks apart."""
    cells = [("cell", arch, shape, rank) for arch, shape in DRYRUN_CELLS
             for rank in (0, 255)]
    trains = [t for t in cells if t[2] == "train_4k"]
    climbs = [("climb", name) for name in ("smollm", "minicpm3", "gemma2")]
    mirrors = [("mirror", name, rank) for name in dryrun_mirrors()
               for rank in range(SHARDED_WORLD)]
    return trains + climbs + [t for t in cells if t not in trains] + mirrors


def dryrun_task(task: tuple) -> tuple:
    """One task in a worker process: (task, its record or its error)."""
    torch.set_num_threads(1)
    try:
        if task[0] == "climb":
            return task, getattr(hillclimb, f"climb_{task[1]}")()
        if task[0] == "cell":
            _, arch, shape, rank = task
            return task, dryrun.lower_cell(
                get_config(arch), SHAPES[shape], multi_pod=False,
                ranks=(rank,), verbose=False)
        _, name, rank = task
        cfg, shape, plan, optimizer = dryrun_mirrors()[name]
        mp = dryrun.plan_of(name, plan, cfg, shape,
                            ParallelismDesc(optimizer=optimizer))
        return task, dryrun.lower_cell(
            cfg, shape, multi_pod=False, mesh_plan=mp,
            mesh_shape={"data": 2, "model": 2}, dtype=torch.float32,
            ranks=(rank,), verbose=False)
    except Exception as e:                          # noqa: BLE001
        return task, {"error": f"{type(e).__name__}: {e}"}


def dryrun_main(out_dir: str) -> None:
    """The dry-run subprocess: every task of ``dryrun_tasks`` over
    DRYRUN_WORKERS forked workers; each cell's ranks merged into one
    record.  Writes ``dryrun.json``."""
    import multiprocessing
    t0 = time.perf_counter()
    cells, climbs, mirrors, errors = {}, {}, {}, []
    with multiprocessing.get_context("fork").Pool(DRYRUN_WORKERS) as pool:
        for task, rec in pool.imap_unordered(dryrun_task, dryrun_tasks()):
            if isinstance(rec, dict) and "error" in rec:
                errors.append(f"{task}: {rec['error']}")
            elif task[0] == "climb":
                climbs[task[1]] = rec
            else:
                into = cells if task[0] == "cell" else mirrors
                key = "/".join(task[1:3]) if task[0] == "cell" else task[1]
                into.setdefault(key, []).append(rec)
    merged = {}
    for key, recs in list(cells.items()) + list(mirrors.items()):
        recs.sort(key=lambda r: r["ranks"][0]["rank"])
        merged[key] = recs[0] | {
            "ranks": [r["ranks"][0] for r in recs],
            "fits": all(r["fits"] for r in recs),
            "wall_s": sum(r["wall_s"] for r in recs)}
    Path(out_dir, "dryrun.json").write_text(json.dumps({
        "cells": {k: merged[k] for k in cells},
        "mirrors": {k: merged[k] for k in mirrors}, "climbs": climbs,
        "errors": errors, "wall_s": time.perf_counter() - t0}))


def phase_dryrun(sharded_train: dict, sharded_recurrent: dict,
                 sharded_encdec: dict) -> dict:
    """The dry run (``launch.dryrun``) in a subprocess (``dryrun_main``):
    (a) production cells at full width on the 16x16 fake mesh, priced at
    the H100: the hillclimb and DRYRUN_CELLS,
    each cell's plan, fit in 80 GiB, GiB a rank, collectives and kernel
    calls printed; (b) phases 17, 19 and 20's runs dry-run on 4 fake ranks
    and held exactly to what those phases measured on the card: each
    rank's slice and optimizer-state bytes, the collective calls of a
    decode step, K2 and K3 calls a step; the dry run's peak printed beside
    each rank's measured peak.  Any error fails the phase."""
    out_dir = ROOT / "build" / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--dryrun", str(out_dir)], timeout=DRYRUN_TIMEOUT)
    sub_s = time.perf_counter() - t0
    if proc.returncode:
        fail(f"dryrun: the subprocess exited {proc.returncode}")
    res = json.loads((out_dir / "dryrun.json").read_text())
    print(f"[dryrun] subprocess {sub_s:.1f} s ({res['wall_s']:.1f} s of "
          f"tasks over {DRYRUN_WORKERS} workers)", flush=True)
    if res["errors"]:
        fail(f"dryrun: {res['errors']}")
    for key, rec in res["cells"].items():
        print(f"[dryrun] (a) {key}: {dryrun.summary(rec)}", flush=True)
    bad = []
    gib = 2 ** 30

    def held(name, measured, kinds, peaks):
        """Check each rank's (b) numbers against the card's ``measured``
        (kind -> a list by rank) and print the peaks beside ``peaks``."""
        rec = res["mirrors"][name]
        got = {k: [fn(r) for r in rec["ranks"]] for k, fn in kinds.items()}
        for k, want in measured.items():
            if got[k] != want:
                bad.append(f"{name} {k}: dry run {got[k]}, card {want}")
        dry_peak = [r["memory"]["peak"] / gib for r in rec["ranks"]]
        print(f"[dryrun] (b) {name}: "
              + "; ".join(f"{k} {got[k]} (card {measured[k]})"
                          for k in measured)
              + f"; peak GiB a rank: dry run "
              f"{[round(p, 3) for p in dry_peak]}, card "
              f"{[round(p, 3) for p in peaks]}, ratio "
              f"{[round(d / c, 3) for d, c in zip(dry_peak, peaks)]}",
              flush=True)
        return {"dry": got, "card": measured, "dry_peak_gib": dry_peak,
                "card_peak_gib": peaks}

    def calls(r):
        return sum(r["collectives"]["calls"].values())
    param = ("params", lambda r: r["memory"]["params"])
    opt = ("opt_state", lambda r: r["memory"]["opt_state"])
    k2 = ("k2", lambda r: r["kernels"]["flash_attention"])
    k2g = ("k2_grad", lambda r: r["kernels"]["flash_attention_grad"])
    k3 = ("k3", lambda r: r["kernels"]["decode_attention"])
    out = {"subprocess_s": sub_s, "cells": res["cells"],
           "climbs": res["climbs"], "mirrors": {}}
    for name, _, _, _, steps in SHARDED_TRAIN_RUNS:
        run = sharded_train["runs"][name]
        out["mirrors"][name] = held(f"sharded_train/{name}", {
            "params": run["param_bytes"], "opt_state": run["opt_bytes"],
            "k2": [x["flash_attention"] // steps for x in run["launches"]],
            "k2_grad": [x["flash_attention_backward"] // steps
                        for x in run["launches"]]},
            dict((param, opt, k2, k2g)), run["peak_gib"])
    for model in SHARDED_RECURRENT:
        run = sharded_recurrent["runs"][model]
        out["mirrors"][model] = held(f"sharded_recurrent/{model}", {
            "params": run["param_bytes"],
            "collective_calls": run["gloo_calls_per_step"]},
            dict((param, ("collective_calls", calls))), run["peak_gib"])
    serve = sharded_encdec["serve"]
    first = sharded_encdec["runs"][WHISPER_BATCHES[0][0]]
    n_new = WHISPER_BATCHES[0][2]
    out["mirrors"]["encdec prefill"] = held("sharded_encdec/prefill", {
        "params": serve["param_bytes"],
        "k2": [p["flash_attention"] for p, _ in first["launches_per_rank"]]},
        dict((param, k2)), serve["peak_gib"])
    out["mirrors"]["encdec decode"] = held("sharded_encdec/decode", {
        "params": serve["param_bytes"],
        "collective_calls": serve["gloo_calls_per_step"],
        "k3": [d["decode_attention"] // n_new
               for _, d in first["launches_per_rank"]]},
        dict((param, ("collective_calls", calls), k3)), serve["peak_gib"])
    train_run = sharded_encdec["train"]
    steps = SHARDED_ENCDEC_TRAIN_STEPS
    out["mirrors"]["encdec train"] = held("sharded_encdec/train", {
        "params": train_run["param_bytes"],
        "opt_state": train_run["opt_bytes"],
        "k2": [x["flash_attention"] // steps for x in train_run["launches"]],
        "k2_grad": [x["flash_attention_backward"] // steps
                    for x in train_run["launches"]]},
        dict((param, opt, k2, k2g)), train_run["peak_gib"])
    if bad:
        fail(f"dryrun: {bad}")
    return out


def main() -> None:
    t_start = time.perf_counter()
    phase_s = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        gc.collect()                # the next phase finds the card free
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"[phase] {name}: {phase_s[name]:.1f} s; this process holds "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of the card "
              f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved), the "
              f"card has {free / 2**30:.2f} of {total / 2**30:.2f} GiB free",
              flush=True)
        return out
    dev = run("device", phase_device)
    # Phases 16-18 share the card with four ranks.  With expandable
    # segments a freed block of this process goes back to the card, so a
    # few live tensors of an earlier phase do not pin whole cached
    # segments; the ranks keep the default allocator.
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    built = run("build", phase_build)
    parity = run("parity", phase_parity)
    times = run("times", phase_times)
    served = run("serve", phase_serve)
    paged = run("paged", phase_paged, served)
    rwkv = run("rwkv", phase_rwkv)
    dense = run("dense", phase_dense)
    window_mla = run("window_mla", phase_window_mla)
    moe_vlm = run("moe_vlm", phase_moe_vlm)
    encdec = run("encdec", phase_encdec)
    llama4 = run("llama4", phase_llama4)
    jamba = run("jamba", phase_jamba)
    cluster = run("cluster", phase_cluster, dense)
    trained = run("train", phase_train)
    sharded = run("sharded", phase_sharded)
    sharded_train = run("sharded_train", phase_sharded_train)
    sharded_paged = run("sharded_paged", phase_sharded_paged)
    sharded_recurrent = run("sharded_recurrent", phase_sharded_recurrent)
    sharded_encdec = run("sharded_encdec", phase_sharded_encdec)
    dry = run("dryrun", phase_dryrun, sharded_train, sharded_recurrent,
              sharded_encdec)
    for key in ("padded_outputs", "first_prompts", "long_outputs"):
        served.pop(key)
    launches = {k: served["serve"]["launches"][k]
                + served["long_batch"]["launches"][k] + paged["launches"][k]
                + dense["launches"][k] + window_mla["launches"][k]
                + moe_vlm["launches"][k] + encdec["launches"][k]
                + llama4["launches"][k] + jamba["launches"][k]
                + trained["launches"][k] + sharded["launches"][k]
                + sharded_train["launches"][k] + sharded_paged["launches"][k]
                + sharded_recurrent["launches"][k]
                + sharded_encdec["launches"][k]
                for k in TIMED}
    launches["wkv6"] += rwkv["launches"]
    kernels = []
    for name, case, src, replaces in (
            ("flash_attention", TIMED["flash_attention"],
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:92"),
            ("decode_attention", TIMED["decode_attention"],
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/decode_attention.py:75"),
            ("paged_attention", TIMED["paged_attention"],
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention/paged_attention.py:137"),
            ("wkv6", TIMED["wkv6"], "src/repro_torch/kernels/csrc/wkv6.cu",
             "src/repro/kernels/wkv6/wkv6.py:70")):
        t = times[f"{name}/{case}"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": parity[f"{name}/{case}/float32"]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    grad = times["flash_attention_grad/smollm_train"]
    print("[train] grad " + json.dumps({
        "name": "flash_attention_grad", "route": "torch ops",
        "source": "src/repro_torch/kernels/flash_attention/grad.py",
        "replaces": None, "backward_calls":
            trained["launches"]["flash_attention_backward"]
            + sharded_train["launches"]["flash_attention_backward"]
            + sharded_encdec["launches"]["flash_attention_backward"],
        "max_abs_err": parity[GRAD_PARITY_TAG]["dq"]["max_abs_err"],
        **{k: grad[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "grad_ms", "grad_bound_ms",
                                "grad_bound_by")}}), flush=True)
    print(f"[profiler] {PROFILER['windows']} windows, each opened by "
          f"{PAD_SPINS} spin kernels: at most {PROFILER['max_lost']} of them "
          f"lost in one, all lost in {PROFILER['all_lost']} (retried)",
          flush=True)
    record = {"device": dev, "build": built, "parity": parity, "times": times,
              "profiler": PROFILER,
              **served, "paged": paged, "rwkv": rwkv, "dense": dense,
              "window_mla": window_mla, "moe_vlm": moe_vlm, "encdec": encdec,
              "llama4": llama4, "jamba": jamba, "cluster": cluster,
              "train": trained, "sharded": sharded,
              "sharded_train": sharded_train, "sharded_paged": sharded_paged,
              "sharded_recurrent": sharded_recurrent,
              "sharded_encdec": sharded_encdec, "dryrun": dry,
              "kernels": kernels,
              "phase_s": phase_s,
              "total_s": time.perf_counter() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"[done] {record['total_s']:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun"]:
        dryrun_main(sys.argv[2])
    else:
        main()
