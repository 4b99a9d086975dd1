#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  prints the card and builds the CUDA kernels from csrc/ (nvcc,
         one process per source, all at once); prints each kernel
         function's registers and spills, and any ptxas warning.
Phase 1  holds each kernel against its plain PyTorch versions on the card:
         the paged attention kernel at llama3_8b's heads (32 / 8 of 128)
         and at mini's (12 / 4 of 64: padded rows) (bf16 and fp32, batch
         8 and 64,
         K = 1 and 4, an inactive slot, a wider table, K = 4 one to three
         cells before a split boundary, batch 1 and 4 at up to 16k tokens
         in 256-page tables, poisoned cells past every slot's frontier;
         pages of 8, 16 and 32 tokens and of 4, 12, 48 and 128 (any page
         size: whole pages per 64-cell stage, or a page over several
         stages) at both head layouts, decode and verify at page and
         stage boundaries, batch 64;
         bf16 held to the split plain version at the wrapper's split by
         PAGED_BF16_TOL and PAGED_BF16_NORM, and to the one-block plain
         version at 2e-2), the flash forward (O and LSE,
         S in {512, 1000, 1024, 2048}, causal and full; 1024 is the
         dense prefill's own shape; 32 query / 8 KV heads), then at the
         bench preset's 8 / 4 heads the flash forward again and the
         flash backward (dq, dk, dv), each at the training step's B=16
         S=2048 and at S=1000, 512, 200 and 64 (200: a ragged second
         128-row tile; 64: shorter than one tile), causal and full, bf16
         (the tensor-core kernels, held per element and by norm:
         FLASH_BF16_TOL, FLASH_BF16_NORM) and fp32 (the scalar ones); the
         bf16 backward runs twice on the same inputs and its run-to-run
         max |ddq| must stay within one bf16 step (dq is summed with
         atomics). The same at moe_bench's 16 / 8 heads of head_dim 64,
         at mini's 12 / 4 heads of 64 (its dense prefill's 1024 tokens,
         S = 1000 and 200), and in bf16 at the bench_8b.py recipe's B=2
         S=4096 with 32 / 8 heads of 128; a head_dim of 96 must be
         refused by all three kernels, and P1's C entry point must refuse
         a split that is not whole stages and a page of 0 tokens.
Phase 2  serves 8 requests on a paged LLMEngine at full llama3_8b width
         and depth (random bf16 weights from a seed), greedy, then 8
         repetitive prompts with speculate=3; checks the paged kernel's
         launch count, profiles a few decode and verify steps (device
         time by kernel class against the wall), recomputes the first
         decode step through the plain path, and checks that admitting
         a request that shares a live request's prefix pages leaves
         those pages byte-identical; holds every greedy and speculative
         token stream to the plain path's, teacher-forced
         (stream_check). The greedy pass again on engines of 16- and
         32-token pages (one P1 launch per layer per step, streams held
         by stream_check), and on an engine of 4-token pages. Then the
         same for mini at full width and depth
         (12 layers, head_dim 64), and its greedy pass at 16-token
         pages.
Phase 3  serves one 1024-token prompt on a dense LLMEngine; checks that
         the flash kernel ran once per layer in prefill and recomputes
         the prefill logits through the plain path; llama3_8b, then
         mini.
Phase 4  frees the serving model and trains the bench preset (24 layers,
         d 1024, flash attention, remat "flash_qkv", fp32 parameters,
         bf16 compute, AdamW with a bf16 first moment) on 16 x 2049
         tokens: two warm-up steps and four timed ones; checks the
         losses and gradient norms and the launches (24 forward + 24
         backward per step); runs a forward + backward in each of the
         eight remat modes on the same weights (time of the second of two
         calls, peak memory, launches per F1_PER_LAYER: 48 forward under
         "full", "attn" and "dots"; loss against flash_qkv's); profiles
         one step, its kernels classed by _private/kernel_profile.py
         (every flash_fwd* kernel counts as F1, every flash_bwd* kernel
         as F2; either at 0 ms fails); captures 3 steps through
         train/profile.py's profile_train_step on the same state (its five
         shares sum to 1 within 10%, mfu above 0, compute_floor at most
         the step's wall) and prints the largest 8 kernels of its
         elementwise class; and holds one batch-2 gradient step through
         the kernels against one through the plain dense attention, in
         bf16 and fp32.
Phase 5  trains moe_bench at full width and depth (6 layers, d 1024, 16 / 8
         heads of 64, 4 experts, top-2; remat "full") on 16 x 2049
         tokens: 12 forward + 6 backward flash launches per step, a
         falling loss and a positive aux loss; profiles one step; holds
         moe_ffn in fp32 to the dense top-k ensemble (the reference's
         oracle).
Phase 6  the bench_8b.py recipe: 4 full llama3_8b layers, vocab 8192,
         remat "full", 2 x 4097 tokens, 2 warm-up and 5 timed steps.
Phase 7  the training loop on the bench preset at full width and depth:
         a token file written from the seed, read through TokenDataset
         (shuffled windows of the file, prefetched, the ragged tail
         dropped), 6 steps; again with a CheckpointManager save at step 3,
         a restore into a fresh state (bit for bit the saved one) and
         steps 4-6, whose losses must equal the uninterrupted run's
         within 2^-8 relative; save and restore seconds and bytes. Then
         train/memory.py's plan beside each peak it prices (phase 4's
         remat full, dots and none, phase 6's recipe): within 15%, and
         fitting the card, since each ran.
Phase 8  the sharded path. (a) F1/F2 at a tp rank's local shapes (the
         bench preset at tp=2: 4/2 heads, B=16 S=2048; llama3_8b at tp=8:
         4/1, B=2 S=4096; moe_bench at tp=2: 8/4 of 64) and P1 at
         llama3_8b tp=2 (16/4) and tp=8 (4/1) and mini tp=4 (3/1 of 64),
         held to their plain versions in fp32 on the same bf16 inputs
         (FLASH_ORACLE_TOL, PAGED_ORACLE_TOL) and timed.
         (b) two ranks spawned on the one card over gloo (correctness
         only: gloo copies every collective through host memory):
         llama3_8b at full width and depth served with mesh {"tp": 2}
         (each rank's pool holds 4 of the 8 KV heads; streams held by
         stream_check), then the first two steps of the bench preset at
         TWO_RANK_LAYERS of its 24 layers (full width) under
         {"fsdp": 2} and {"tp": 2} with no learning-rate warm-up, held to
         the same steps in one process (losses within TWO_RANK_LOSS_REL,
         gradient norms within TWO_RANK_NORM_REL), with each rank's flash launches and peak
         memory beside plan_memory.
Phase 9  two ranks on the one card over gloo (correctness only), each
         run against the same work in one process: (a) the bench preset
         pipelined (parallel/pipeline.py) over {"pp": 2}, 4 microbatches
         of phase 4's 16 x 2048 batch, 12 layers per stage (flash,
         remat "flash_qkv"), the embedding before the pipeline and the
         final norm + chunked CE as the loss head: the loss within
         TWO_RANK_LOSS_REL and each parameter's gradient norm within
         TWO_RANK_NORM_REL, (M + P - 1) x 12 = 60 F1 and F2 launches per
         rank; F1/F2 at the microbatch's shape (B=4) held to their plain
         versions in fp32 (FLASH_ORACLE_*) and timed; (b)-(c) and (e)
         at phase 8b's depth (TWO_RANK_LAYERS): (b) two bench steps
         under {"sp": 2} with flash (the sequence gathered over sp);
         (c) under {"tp": 2} with remat "flash_qkv_ffn8", every int8
         value and scale the step's kept op makes (on every
         INT8_ROW_STRIDE-th row) equal to the whole rows' quantization;
         (d) moe_bench under {"sp": 2} with 2048-token routing groups
         that span the ranks (MOE_LOSS_REL, MOE_AUX_REL, MOE_NORM_REL);
         (e) phase 8b's fsdp = 2 run on
         make_multislice_mesh({}, {"fsdp": 2}) over two one-rank fake
         slices: step 0's loss bit for bit phase 8b's. Every phase prints
         its seconds.
Phase 10 the port's runtime (ray_tpu_torch.init) on the card: the node
         detects the GPU as a resource without a CUDA context (checked in
         a fresh process); a num_gpus=1 task runs F1 in its own worker at
         phase 3's prefill shape (B=1, S=1024, 32 / 8 heads of 128, bf16;
         O held to the plain version in fp32 by FLASH_ORACLE_*, one
         launch), its lease bound to the node's one card
         (CUDA_VISIBLE_DEVICES naming it, CUDA_DEVICE_ORDER=PCI_BUS_ID,
         one CUDA device); mini's parameters go into the object store as one put
         of a numpy tree, and a num_gpus=1 actor builds mini's paged
         LLMEngine from them and serves phase 2's mini prompts, greedy:
         its streams must equal phase 2's token for token and its P1 and
         F1 launches phase 2's; its dense engine serves phase 3's prompt
         (stream and F1 launches equal to phase 3's: the paged engine
         prefills without F1); while it holds the GPU a second
         num_gpus=1 task must wait, and run once the actor is killed;
         the actor's memory sample (runtime/memory.py) must read its
         torch.cuda.memory_allocated within 1% and claim the paged pool's
         bytes, and the head's memory ledger must show it; two
         num_gpus=0.5 actors must see the same card. Prints the init,
         first GPU task, actor cold start and decode times.
Phase 11 the collective data plane and the device-object transport:
         (a) every verb and mode of NcclMeshGroup (allreduce sum, max,
         min, product, ring, tree, int8, partial with one rank masked,
         both at once; reduce; allgather, int8; reducescatter, tree,
         max, int8, partial; broadcast; permute; the async verbs;
         barrier) with 4 ranks on cuda:0 (the device-local route), fp32
         and bf16, against the same verb on 4 CPU ranks: integer data
         exactly, random data at rtol 1e-5 (fp32) or one bf16 step, int8
         within one quantization step; (b) the bench preset's whole
         gradient tree (444M fp32 leaves named as in init_params, 1.78 GB
         per rank) on each of the 4 ranks, synced through GradBucketer:
         the bucket plan, ms per sync cold and warm beside the bound
         (every rank's tree read and written once over the HBM rate), the
         synced mean against the mean computed in one place, then with
         int8 compression within the codec's bound; (e) hierarchical_
         allreduce over 2 fake slices of 2 ranks against the flat
         allreduce, with slice 1 skipped, and with its int8 inter-slice
         hop; (c) through the runtime, a world-1 group on NCCL in a
         num_gpus=1 task (every verb on CUDA tensors; then NCCL asked for
         two ranks on the one card, its answer printed), and two
         num_gpus=0.5 actors in a 2-rank "nccl" group on an explicit gloo
         backend (CUDA tensors staged through host memory) held to numpy;
         (d) one of them returns a 256 MiB CUDA tensor under
         tensor_transport and the other gets it, over the RPC fetch and
         over the group's send/recv: bits equal, seconds and GB/s.
Phase 12 the Train library on the runtime: (a) the bench preset's
         train state at P12_LAYERS of its 24 layers (full width) saved
         through checkpoint.AsyncCheckpointer into the
         shard store (the seconds save() stalls the caller beside phase
         7's torch.save, the background persist's seconds, logical and
         written bytes), again after one step (the dedup ratio), and
         restored into a fresh state bit for bit; (b) TorchTrainer with
         one GPU worker trains the bench preset at P12_LAYERS of its 24
         layers (full width) 2 steps, checkpointing
         through report(checkpoint=uri), and a second fit resumes from
         the store for steps 3-4: losses within 2^-8 relative of an
         uninterrupted 4-step run, one F1 + one F2 launch per layer per step,
         tokens/s through the trainer and the controller's seconds per
         step; (c) TorchTrainer with two half-GPU workers over gloo on
         an fsdp=2 mesh: (b)'s step-2 checkpoint restored resharded (each
         local shard bit for bit its slice of the saved leaf), the bench
         preset's first two steps at phase 8b's depth (TWO_RANK_LAYERS)
         under fsdp=2 (losses and gradient norms within
         TWO_RANK_LOSS_REL / TWO_RANK_NORM_REL of the same steps in one
         process), and that state checkpointed from both ranks, every
         leaf whole in the merged manifest, and restored.
Phase 13 Serve on the runtime: (a) serve.run(build_llm_deployment(
         "llama3_8b", ...)) with one num_gpus=1 replica, which draws the
         full-size weights from the seed in its own process (max_batch 8,
         64-token pages); the HTTP proxy; the replica's cold start to its
         first answer; phase 2's 8 prompts at once, 4 as unary JSON and 4
         as SSE streams ending in data: [DONE], 32 greedy tokens each
         (after a 2-token warm-up pass); the replica's engine stats, read
         from the replica actor, must show P1 launched 32 times per decode step (its
         process counted from 0); every stream held by stream_check to
         the plain path on the same weights drawn again in the driver
         after the deployment is deleted; client TTFT (SSE), the engine's
         ttft_s (unary) and SSE decode tokens/s per stream. (b) mini as 2
         replicas of num_gpus=0.5: 16 requests through a DeploymentHandle,
         both replicas answer and launch P1 (12 per decode step each),
         the GPU fully leased; one replica SIGKILLed
         (_private/test_utils.kill_one_replica) under 24 unary requests,
         which all answer; the replacement takes its half GPU back; every
         stream held by stream_check; serve.shutdown() gives the GPU back.
Phase 14 Compiled Graphs: two num_gpus=0.5 actors each run F1 at phase
         10's shape on inputs drawn on the card from the seed the graph's
         input carries (plus the rank); an allreduce node sums their O's
         on the card (each rank's result a bf16 CUDA tensor, equal on both
         ranks, held to the sum of the same two F1 calls in the driver by
         FLASH_ORACLE_*); one F1 launch per execute in each actor; the
         microseconds per execute() over 20 beside the same two calls by
         .remote() and get, the bytes per step through the shared-memory
         channels, and, for where the step's time goes, the same graph
         without its allreduce and one returning O's norms (beside the
         norms by .remote()); teardown removes the channels, and shutdown
         leaves no store segment and no worker process.
Phase 15 Ray Data on the runtime: (a) phase 2's 8 prompts (token lists
         of 20 to 1500 ids) as one block of ray_tpu_torch.data.from_items
         through map_batches(cls, batch_size=8, compute="actors",
         concurrency=1), cls the class build_batch_inferencer returns for
         llama3_8b (phase 13's engine, drawn from the seed in the data
         actor, which holds no GPU lease) with columns added: the token
         ids as an int64 CUDA tensor (the block module makes it host
         numpy), the engine's decode steps, the actor's P1 / F1 launches;
         8 of 8 streams equal phase 2's, the generated column phase 2's
         streams decoded, P1 32 per decode step; the actor gone and the
         card as free as before once take_all() returns; the seconds from
         map_batches to the rows and decode tokens/s per stream. (b)
         phase 12b's first 3 batches (48 rows of 2049 ids) as a 4-block
         from_numpy Dataset into TorchTrainer(datasets={"train": ds}),
         one GPU worker on the bench preset: get_dataset_shard("train")
         .iter_batches(batch_size=16), each batch moved to the card in a
         step_span's data_wait phase; losses within 2^-8 relative of
         phase 12b's uninterrupted run's first three, one F1 + one F2
         launch per layer per step, every row read once in order (a CRC per row);
         tokens/s beside phase 12b's and data_wait per step.
Phase 16 Tune on the runtime: Sweeps of TorchTrainer gangs, each trial
         one worker on a 0.5 GPU lease (two gangs share the card) training
         phase 12b's bench step (full width, P12_LAYERS) on 12b's batches
         at its own learning rate, reporting loss every step. (a)
         LedgerASHA (grace 2, factor 2) over lr 3e-4, 1e-4, 3e-5, 1e-5, 4
         steps each, admitted with the memory planner's price: every trial
         TERMINATED, at least one stopped at the rung with fewer than 4
         steps and every stopped one at a rung (2 or 4; a trial at a rung
         waits for the decision), at most two
         loops at a time and at least two overlapping, the sampled free GPU
         reaching 0 and never below, one F1 + one F2 per layer per step, the lr 3e-4
         trial's losses within 2^-8 of phase 12b's uninterrupted run, the
         head's sweep row FINISHED with every trial journaled; once a
         trial has reported step 1 to the head's train ledger this
         process calls util.state.profile_capture(steps=1), and at least one
         profile:step span reaches the head with the reference's keys
         and a measured matmul time above 0 (the trial loop calls
         train/profile.py's step_hook after each step: its report()
         steps carry the loss the ledger ranks). (b)
         LedgerPBT (interval 2, quantile 0.5, lr mutation 1e-4) over lr
         3e-4 and 3e-6, 6 steps, each trial saving through
         AsyncCheckpointer at step 2, reporting that step once every
         trial's save has committed and then waiting until the fork is
         journaled before it steps on (a relaunch steps once its source
         has ended or was itself forked from it): one fork, the winner's manifest in the loser's run with
         no new chunk (dedup ratio 1), the relaunched loser at the
         mutation, its restored state bit for bit the winner's checkpoint
         and its first loss within 1e-5 of the winner's at that step, the
         lineage in sweep_stats, one + one per layer per step; the card as free after
         the sweeps as before. Prints each sweep's makespan and
         chip_idle_fraction, each trial's fit set-up seconds and tokens/s,
         the saves' stall and persist seconds, the fork's seconds and the
         relaunch's seconds to its first restored step.
Phase 17 RL on the runtime, the learner on the card in this process and 2
         env-runner actors on the CPU: (a) PPO on the chain (the JAX
         package's tests/test_rl.py configuration), 15 iterations: mean
         return above 0.5, the learner's params on cuda, the greedy action
         at the start state 1, and the first learner update done again on
         the CPU through the port on the same batch and weights (loss and
         grad_norm within 1e-5 relative, every param within 1e-5 of its
         leaf's largest magnitude); (b) APPO on the chain (its
         tests/test_rl_appo_connectors.py configuration), 80 iterations:
         finite loss, mean return above 0.5, greedy action 1, and the
         target network frozen between refreshes and equal to the online
         params after one. Prints each learner update's ms, the sample ms
         per iteration and env steps/s.
Phase 17c (in phase 17's runtime) parallel/showcase.py's
         composed_trainer_loop through TorchTrainer.fit: 4 workers of 0.25
         GPU over gloo on the {pp: 2, ep: 2, fsdp: 1} mesh, 2 steps with
         the bucketed overlap sync (1 KiB buckets): no error, a
         checkpoint with params.npz, at least 2 buckets, a finite loss,
         exposed comm in the head's train ledger; loss, gradient norm and
         every step's params within 1e-5 of the program's plain
         arithmetic on the CPU from the same parameters (p17c_plain).
Phase 18 (run after phase 16, before 17) ResNet (models/resnet.py):
         resnet18 at its published widths on
         the JAX package's synthetic recipe at 32 x 32, B=256, bf16
         convolutions (channels_last, cuDNN): the first step's loss and
         gradients held to the same step in fp32 on the CPU
         (P18_LOSS_REL, P18_GRAD_REL, and each gradient leaf to
         P18_LEAF_K times the CPU's own bf16 step's reading on it in the
         same run), 30 Adam steps whose loss ends
         below half the first, images/s over steps 10-30; resnet50's
         forward at B=8, 224 x 224: finite fp32 [8, 1000] logits.
Phase 19 (run while phase 17c's fit starts its workers) the port's
         own cluster from its CLI: `start --head --port 0` (auth on,
         session under build/chip_smoke/p19), `status` showing one node
         with GPU 1.0 detected from the card; a job submitted through the
         job REST of a `scripts dashboard` process (POST /api/jobs, then
         GET /api/jobs/<id> until it ends) whose entrypoint (a script
         written there) connects with ray_tpu_torch.init(address=...) and serves
         phase 2's mini prompts from a num_gpus=1 task (weights drawn from
         the seed on the card): SUCCEEDED, every stream equal to phase
         2's, P1 launched 12 times per decode step (added to the kernels
         line's paged_attention_d64 count); `list jobs`, `head --json`,
         `mem --json` exit 0. The job also registers p19_serve_mini with
         the port's xlang.register_function (msgpack in and out: the
         prompts, max_tokens, the seed). A C++ driver (P19_DRIVER,
         built with the port's C++ client by g++ beside phase 0's
         kernels, no Python in it) calls it through raytpu::Driver on
         the CLI's head with its token: the function serves the prompts
         from a num_gpus=1 task (its own lease holds a CPU only), and the
         driver prints every stream: 8 of 8 equal phase 2's, P1 launched
         12 times per decode step (added to paged_attention_d64's count),
         and a name never registered comes back as an error text. Then
         `stop` leaves no daemon alive.
Phase 20 an autoscaled GPU node serving mini from an ActorPool: a runtime
         whose head node offers no GPU (its resources say GPU 0), an
         Autoscaler over FakeNodeProvider with one node type {"CPU": 2,
         "GPU": 1} (max_workers 1); two num_gpus=0.5 actors make it add
         exactly one node, and both run on the node the provider maps its
         id to. Each draws mini on the card from the seed and serves pool
         items (one of phase 2's mini prompts each, greedy, phase 2's
         max_tokens), its decode loop wrapped in a tqdm_ray bar, and puts
         (item, P1 launches, decode steps) from its engine's counters on a
         util.queue.Queue: half the items through ActorPool.map (order
         held), half through map_unordered (the set held); every stream
         equal to phase 2's or held by stream_check, P1 = 12 x decode
         steps per item, the driver's tqdm_ray display seeing every bar at
         its total. The actors killed, the autoscaler terminates the idle
         node within its idle timeout plus a few intervals and the head
         counts no GPU. The P1 launches are not in the kernels line.
Phase 21 the perf harnesses on the card (_private/llm_perf.py and
         _private/perf.py): (a) llm_perf's three op rows at batch 64 (the
         bench model's 8 / 4 heads of 128 and llama3_8b's 32 / 8 at
         32-page tables, 16 slots of 2048 keys and 48 of 257; llama3_8b's
         at 128-page tables, 8 slots of 7001 and 56 of 301), P1 held to
         the gather path (paged_kv._gather_page_attention) on the same
         inputs at phase 1's one-block limit (2e-2), each timed both ways
         over P21_STEPS calls beside the bound of its live K/V bytes; (b)
         decode@64 on bench at full width and depth (16 requests of 1500
         tokens and 48 of 128, 64-token pages, 2048 pages), the kernel
         engine then the gather engine (RAY_TPU_PAGED_ATTN 1 and 0),
         P21_STEPS timed steps each: P1 = 24 x the kernel engine's decode
         steps and none in the gather engine, the prefill's token equal in
         every request, the first decoded token equal or, where bf16 makes
         it differ, that request's streams held by stream_check, as are
         both engines' streams of P21_CHECKED's 8 requests; (c) the
         prefill stall on bench (9 slots, max_seq 8192, a 7936-token
         prompt admitted among 8 decoding requests, 16 timed steps),
         chunked (1024) then monolithic: the chunked engine's
         prefill_chunks 16 (both long prompts), the monolithic's 0, P1 =
         24 x each engine's decode steps, the 8 decode streams equal
         across the engines (else each engine's held by stream_check),
         the peak device memory of each; (d) perf.llm_decode_bench(
         quick=True), mini on the card. llm_perf.check_floors holds the
         readings: its relative floors (op speedups above 0.9, 1.0 and
         1.5, decode@64 above 0.8, stall_ratio_p99 above 1.3) and the
         card's ceilings on the op rows.
Timing   each kernel at the main path's shapes (CUDA events, cold L2):
         its time, its plain version's, its bound (P1 also at the verify
         step's K = 4 and at batch 64, on lines of their own), and for the flash
         kernels the time of PyTorch's scaled_dot_product_attention
         (forward; forward + backward minus forward for the backward).

Prints a ``{"kernels": [...]}`` line (the paged kernel twice,
"paged_attention" at llama3_8b's first decode step and
"paged_attention_d64" at mini's, "paged_attention_p16",
"paged_attention_p32" and "paged_attention_p4" at llama3_8b's first decode
step with 16-, 32- and 4-token pages, launches from phase 2's runs at
those pages; the flash
forward three times:
"flash_fwd" at the prefill's shape, "flash_fwd_train" at the bench
training step's, "flash_fwd_train_d64" at moe_bench's; the backward twice,
"flash_bwd" and "flash_bwd_d64"; and the tp=2 shapes phase 8b runs,
"paged_attention_tp2", "flash_fwd_train_tp2" and "flash_bwd_tp2", with
both ranks' launches, and the pipeline's microbatch shape phase 9a runs,
"flash_fwd_train_pp" and "flash_bwd_pp", with both ranks' launches, and
phase 16's sweep trials at phase 4's shape, "flash_fwd_train_sweep" and
"flash_bwd_sweep" (phase 4's timed rows, with every trial worker's
launches), and phase 21's bench engines, "paged_attention_bench" (P1 at
decode@64's shape, launches of 21b's kernel engine) and
"paged_attention_stall" (P1 at the prefill stall's B=9, 128-page shape,
launches of 21c's two engines; 21a's timing loops count in no row, 21d's
mini launches count in "paged_attention_d64"); each
with its own launches and error; the other phase 8a shapes on a line of
their own; phase 9b's sp-gathered F1/F2 run at phase 4's shape, whose row
carries phase 4's launches),
a ``{"collectives": {...}}`` line with phase 11's readings, a
``{"laps": {...}}`` line with each phase's seconds, a
``{"llm_perf": {...}}`` line with phase 21's, the card's
name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero;
without a CUDA device it exits 1 before any phase.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import glob
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types

_PROCESS_T0 = time.time()  # before numpy and torch load

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Readings too long for the log (JSON), under the working directory.
OUT_DIR = os.path.join("build", "chip_smoke")
# Peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, dense bf16 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
NVLINK_BYTES_PER_S = 450e9  # one way per H100 SXM (NVLink 4, data sheet)
# Page sizes other than 64 that phase 1 holds P1 to its plain versions at:
# whole pages per 64-cell stage (4: 16 pages; 8, 16, 32; 12: five pages,
# 60 cells; 48: one page, 48 cells) and a page over two stages (128).
# Phase 2 serves both models at 16, llama3_8b at 32 and at 4.
OTHER_PAGES = (4, 8, 12, 16, 32, 48, 128)

# The bf16 flash kernels against their plain versions. Both sides round at
# the same points (q pre-scaled, p and ds to bf16 before their products)
# from fp32 values summed in other orders, so a rounded p or ds may land one
# bf16 step apart: a few bf16 steps of p . v or ds . k per element, and a
# norm-relative error of a few 1e-3 at most. The limits sit 1.5 and 2 times
# above the worst readings (PERF.md), which each comparison prints. A key
# tile or one group head's share left out fails them by far; O or dq off
# by 1% everywhere fails them too, where atol = rtol = 2e-2 would pass it.
FLASH_BF16_TOL = (2e-3, 1e-2)  # atol, rtol per element
FLASH_BF16_NORM = 5e-3  # limit of ||got - want|| / ||want||
# The bf16 paged kernel against paged_attention_split_reference at the
# wrapper's own split: the same rounding points (p to bf16 against each
# page's running max, per split; the fp32 combine), fp32 sums in other
# orders, so a rounded p may land one bf16 step apart and the output one
# bf16 step (within 1e-2 |want|). Worst readings over phase 1's cases:
# 1.1e-4 beyond 1e-2 |want|, norm-relative 3.3e-4 (PERF.md); the limits
# sit 1.8 and 3 times above them. A split left out of the combine, a page
# left out of a split or the exp(m_s - M) rescale left out fails them by
# two orders of magnitude (paged_attention_chip.py mutants).
PAGED_BF16_TOL = (2e-4, 1e-2)  # atol, rtol per element
PAGED_BF16_NORM = 1e-3  # limit of ||got - want|| / ||want||
# Pages other than 64 tokens (phase 1's OTHER_PAGES cases) hold the bf16
# kernel to the plain version in fp32 on the same bf16 inputs
# (PAGED_ORACLE_TOL, PAGED_ORACLE_NORM, as phase 8a does) and to the split
# plain version by PAGED_BF16_NORM; the split version's own distance from
# fp32 is printed beside. Held to the bf16 split version by
# PAGED_BF16_TOL, one page-8 batch-64 case read 5.7e-4 beyond 1e-2 |want|
# (past its 2e-4) where the bf16 kernel and the bf16 split version read
# the same distance from fp32 (9.6e-4 beyond): p rounded one bf16 step
# apart near a small output; in fp32 the kernel equals the split version
# within 1.2e-6 at every page size (PERF.md).
# Phase 8a holds the bf16 kernels at a tp rank's head layouts to their
# plain versions in fp32 on the same bf16 inputs (the exact function of
# what each kernel is given), not to the plain bf16 versions: at
# llama3_8b's tp=8 layout (4/1 heads) the kernel and the plain bf16
# version differed beyond the limits above at one element each (F2's dk at
# B=2 S=4096, P1 at B=64 K=4). Both round O, dq, dk, dv and P1's output to
# bf16, and p and ds before their products, so each sits a few bf16 steps
# per element from the fp32 result, the plain bf16 versions as far as the
# kernels. Sound kernels over phase 8a's layouts read at most 1.14e-2 beyond
# 1e-2 |want| and 3.4e-3 norm-relative (F2; F1 4.3e-3 and 2.8e-3), P1
# 2.2e-3 and 2.2e-3; the limits sit 1.75-1.85 times above them. Each
# planted fault (a key tile, the rescale, delta, a dq tile, a dk step, the
# causal mask one key late; a split, a page, P1's rescale) reads at least
# 0.48 beyond and 0.29 norm-relative at every layout (sharded_chip.py
# kernel-faults; PERF.md PR 7).
FLASH_ORACLE_TOL = (2e-2, 1e-2)  # atol, rtol per element
FLASH_ORACLE_NORM = 6e-3  # limit of ||got - want|| / ||want||
PAGED_ORACLE_TOL = (4e-3, 1e-2)  # atol, rtol per element
PAGED_ORACLE_NORM = 4e-3  # limit of ||got - want|| / ||want||


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log):
    """Each kernel function's registers and spills from nvcc's
    ``-Xptxas -v`` output, then any ptxas warning line and any note of a
    performance loss (ptxas reports serialised wgmma as an info line)."""
    rows, warnings, name, spills = [], [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            found = re.search(r"[a-z_]*kernel", mangled)
            name = found.group(0) if found else mangled
            if "bfloat16" in mangled:
                name += "<bf16>"
            elif re.search(r"kernelIf", mangled):
                name += "<fp32>"
            # integer template arguments (P1's rows per block)
            name += "".join(f"<{n}>" for n in re.findall(r"Li(\d+)E",
                                                         mangled))
        elif "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill", line)
            spills = f"spills {stores}/{loads} B"
        elif "Used" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            rows.append(f"{name} {regs}, {spills}")
        elif "warning" in line.lower() or "Performance" in line:
            warnings.append(f"{name}: {line.strip()}")
    return rows + warnings


def compare(name, got, want, atol, rtol, norm=None):
    """Fail unless |got - want| <= atol + rtol * |want| everywhere and,
    where ``norm`` is given, ||got - want|| / ||want|| <= norm; prints the
    largest |got - want| - rtol * |want| (held to atol) and returns the
    max abs error."""
    got, want = got.float(), want.float()
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    err = (got - want).abs()
    excess = float((err - rtol * want.abs()).max()) if finite else math.inf
    ok = finite and excess <= atol
    max_err = float(err.max()) if finite else math.inf
    rel = ""
    if norm is not None:
        r = float(err.norm() / want.norm()) if finite else math.inf
        ok = ok and r <= norm
        rel = f", norm-rel {r:.3e} (limit {norm})"
    print(f"  {name}: max_abs_err={max_err:.3e}, beyond rtol {excess:.3e} "
          f"(atol={atol}, rtol={rtol}; max|want|="
          f"{float(want.abs().max()):.3e}){rel} {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} exceeds its tolerance")
    return max_err


def distance(got, want, rtol):
    """The readings compare holds, as text, for a line that holds nothing:
    the largest |got - want| - rtol * |want| and the norm-relative error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return (f"beyond rtol {float((err - rtol * want.abs()).max()):.3e} "
            f"(rtol={rtol}), norm-rel {float(err.norm() / want.norm()):.3e}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, with L2 flushed before each call
    (the main path reaches each kernel after other layers' weights have
    passed through the cache). The stream is held ~0.5 ms after the flush,
    so that the host's time to issue the call (Python, ctypes) passes
    while the device is still busy and not between the two events."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)  # clock cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# ------------------------------------------------------------ paged case
def paged_case(b, kq, lengths, max_pages, dtype, seed, page_size=64,
               n_heads=32, n_kv=8, head_dim=128, inactive=(),
               extra_pages=8, poison=True, device="cuda"):
    """Inputs of one paged-attention call: pages shuffled across the pool,
    a table per slot covering positions .. positions + K - 1, slots in
    ``inactive`` all -1 at position 0, and (``poison``) V cells past each
    slot's frontier set to 1e4 so that any unmasked stale cell shows."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    positions = torch.tensor(lengths, dtype=torch.int32)
    need = [(int(p) + kq - 1) // page_size + 1 for p in lengths]
    n_pages = sum(need) + 1 + extra_pages
    perm = torch.randperm(n_pages - 1, generator=g) + 1  # page 0 = dump
    tables = torch.full((b, max_pages), -1, dtype=torch.int32)
    start_pos = torch.full((n_pages,), -1, dtype=torch.long)
    owner_lim = torch.zeros((n_pages,), dtype=torch.long)
    nxt = 0
    for i in range(b):
        if i in inactive:
            positions[i] = 0
            continue
        ids = perm[nxt: nxt + need[i]]
        nxt += need[i]
        tables[i, : need[i]] = ids.to(torch.int32)
        start_pos[ids] = torch.arange(need[i]) * page_size
        owner_lim[ids] = int(positions[i]) + kq
    shape = (n_pages, n_kv, page_size, head_dim)
    q = torch.randn((b, kq, n_heads, head_dim), generator=g)
    k_pool = torch.randn(shape, generator=g)
    v_pool = torch.randn(shape, generator=g)
    if poison:
        cell = start_pos[:, None] + torch.arange(page_size)[None, :]
        stale = (start_pos[:, None] >= 0) & (cell >= owner_lim[:, None])
        v_pool.masked_fill_(stale[:, None, :, None], 1e4)
    to = dict(device=device)
    return (q.to(dtype=dtype, **to), k_pool.to(dtype=dtype, **to),
            v_pool.to(dtype=dtype, **to), tables.to(**to),
            positions.to(**to))


def paged_checks(device="cuda", heads=(32, 8, 128), oracle=False,
                 per_page=None):
    """P1 against its plain versions in every case, bf16 and fp32, at one
    head layout ``heads`` = (query heads, KV heads, head_dim): llama3_8b's
    by default, mini's (12, 4, 64) for the head_dim-64 build, where 3 query
    rows per KV head at decode and 12 at K = 4 leave padded rows in the
    kernel's row blocks of 4 and 16.

    bf16 is held to the split plain version at the wrapper's own split
    (``PAGED_BF16_TOL`` per element, ``PAGED_BF16_NORM`` by norm) and to
    the one-block plain version at atol = rtol = 2e-2 (p rounded against
    the row's max there, against each page's running max in the kernel);
    fp32 to both at 1e-4 (the same arithmetic in another summation
    order). With ``oracle`` (phase 8a) bf16 is held instead to the plain
    version in fp32 on the same bf16 inputs (``PAGED_ORACLE_TOL``,
    ``PAGED_ORACLE_NORM``), and the split plain version's own distance
    from it is printed beside. Returns the worst bf16 error against the
    yardstick over the 64-token pages (``per_page``, when given, gets the
    worst against fp32 at each smaller page size, whose cases it adds)."""
    from ray_tpu_torch.ops.paged_attention import (
        kernel_split,
        paged_attention,
        paged_attention_reference,
        paged_attention_split_reference,
    )

    rng = np.random.default_rng(1)
    cases = []
    for b in (8, 64):
        lengths = rng.integers(1, 2000, size=b)
        lengths[:4] = [0, 63, 64, 127][: min(4, b)]  # page boundaries
        for kq in (1, 4):
            cases.append((f"B={b} K={kq}", b, kq, lengths.tolist(), 32, ()))
    cases.append(("B=8 K=1 inactive slot 3", 8, 1,
                  rng.integers(1, 2000, size=8).tolist(), 32, (3,)))
    cases.append(("B=8 K=4 wide table (64 pages)", 8, 4,
                  rng.integers(1, 2000, size=8).tolist(), 64, ()))
    # K = 4 one to three cells before a split boundary (two pages per
    # split at 32 pages, four at 64): rows of the last live split that see
    # none of its cells.
    cases.append(("B=8 K=4 split boundaries (32 pages)", 8, 4,
                  [61, 62, 63, 125, 126, 127, 189, 1021], 32, ()))
    cases.append(("B=8 K=4 split boundaries (64 pages)", 8, 4,
                  [125, 126, 127, 253, 254, 255, 381, 3000], 64, ()))
    # Long context, 256-page tables: many live splits per slot.
    cases.append(("B=1 K=1 long (256 pages)", 1, 1, [16000], 256, ()))
    for kq in (1, 4):
        lengths = rng.integers(1, 16384 - kq, size=4)
        lengths[0] = 16384 - kq
        cases.append((f"B=4 K={kq} long (256 pages)", 4, kq,
                      lengths.tolist(), 256, ()))
    cases = [c + (64,) for c in cases]
    # Pages of 8, 16 and 32 tokens (a kernel stage holds 64 / P of them;
    # the last one of a slot is cut short) and of 4, 12, 48 and 128 (16
    # pages per stage; five pages, every stage 60 of 64 cells; one page of
    # 48 cells; a page over two stages), tables of max_seq 2048: decode
    # and verify at page and stage boundaries, and a long slot.
    for page in OTHER_PAGES if per_page is not None else ():
        n = -(-2048 // page)
        cases.append((f"P={page} B=8 K=1", 8, 1,
                      [0, page - 1, page, 63, 64, 900, 1500, 2040], n, (),
                      page))
        cases.append((f"P={page} B=8 K=4 boundaries", 8, 4,
                      [page - 3, 2 * page - 2, 61, 62, 125, 700, 1021, 2040],
                      n, (3,), page))
        cases.append((f"P={page} B=64 K=1", 64, 1,
                      rng.integers(1, 2000, size=64).tolist(), n, (), page))
    worst = {"err": 0.0, "excess": 0.0, "norm": 0.0}
    h, hkv, dh = heads
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, kq, lengths, max_pages, inactive, page in cases:
            args = paged_case(b, kq, lengths, max_pages, dtype, seed=b + kq,
                              page_size=page, n_heads=h, n_kv=hkv,
                              head_dim=dh, inactive=inactive, device=device)
            pps = kernel_split(*args[:2], args[3]) if device == "cuda" else 1
            got = paged_attention(*args)
            split = paged_attention_split_reference(*args, pps)
            single = paged_attention_reference(*args)
            sync()
            name = f"paged H={h}/{hkv} D={dh} {label} {str(dtype)[6:]}"
            if dtype == torch.bfloat16:
                if oracle or page != 64:
                    atol, rtol = PAGED_ORACLE_TOL
                    want = paged_attention_reference(
                        *(t.float() for t in args[:3]), *args[3:])
                    e = compare(f"{name} vs fp32", got, want, atol, rtol,
                                PAGED_ORACLE_NORM)
                    print(f"    plain bf16 (split) vs fp32: "
                          f"{distance(split, want, rtol)}")
                    if page != 64:
                        compare(f"{name} vs split ({pps} pages/split), "
                                f"by norm", got, split, 1.0, 0.0,
                                PAGED_BF16_NORM)
                else:
                    atol, rtol = PAGED_BF16_TOL
                    want = split
                    e = compare(f"{name} vs split ({pps} pages/split)", got,
                                split, atol, rtol, PAGED_BF16_NORM)
                    compare(f"{name} vs one block", got, single, 2e-2, 2e-2)
                if page != 64:
                    per_page[page] = max(per_page.get(page, 0.0), e)
                    continue
                err = (got.float() - want.float()).abs()
                worst["err"] = max(worst["err"], e)
                worst["excess"] = max(worst["excess"], float(
                    (err - rtol * want.float().abs()).max()))
                worst["norm"] = max(worst["norm"], float(
                    err.norm() / want.float().norm()))
            else:
                compare(f"{name} vs split ({pps} pages/split)", got, split,
                        1e-4, 1e-4)
                compare(f"{name} vs one block", got, single, 1e-4, 1e-4)
    print(f"  paged H={h}/{hkv} D={dh} bf16 vs "
          f"{'fp32' if oracle else 'split'}, worst: max_abs_err "
          f"{worst['err']:.3e}, beyond rtol {worst['excess']:.3e}, norm-rel "
          f"{worst['norm']:.3e}")
    return worst["err"]


def phase1(device="cuda"):
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_forward,
        flash_attention_reference,
    )

    print("phase 1: kernels against their plain versions")
    # fp32 tolerance: the same arithmetic in another summation order.
    tol = {torch.bfloat16: FLASH_BF16_TOL, torch.float32: (1e-4, 1e-4)}
    per_page = {}  # pages under 64 tokens, both head layouts
    errs = {"paged": paged_checks(device, per_page=per_page),
            "paged_d64": paged_checks(device, heads=MINI_HEADS,
                                      per_page=per_page),
            "flash": 0.0}
    errs.update({f"paged_p{page}": e for page, e in per_page.items()})

    g = torch.Generator(device="cpu").manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = tol[dtype]
        norm = FLASH_BF16_NORM if dtype == torch.bfloat16 else None
        for s in (512, 1000, 1024, 2048):  # 1024: phase 3's prefill
            q = torch.randn((1, s, 32, 128), generator=g)
            k = torch.randn((1, s, 8, 128), generator=g)
            v = torch.randn((1, s, 8, 128), generator=g)
            q, k, v = (t.to(device=device, dtype=dtype) for t in (q, k, v))
            for causal in (True, False):
                o, lse = flash_attention_forward(q, k, v, causal)
                o_ref, lse_ref = flash_attention_reference(q, k, v, causal)
                sync()
                label = f"flash S={s} causal={causal} {str(dtype)[6:]}"
                e = compare(label + " O", o, o_ref, atol, rtol, norm)
                # LSE is fp32 from the same rounded inputs in both.
                compare(label + " LSE", lse, lse_ref, 1e-4, 1e-4)
                if dtype == torch.bfloat16:
                    errs["flash"] = max(errs["flash"], e)
    # The bench preset's heads (F1/F2 at head_dim 128), moe_bench's (head
    # dim 64: the training shape, ragged S, fp32), mini's (head_dim 64 with
    # n_rep = 3: its dense prefill's 1024 tokens, ragged S) and the
    # bench_8b.py recipe's llama3_8b layers at B=2 S=4096 (bf16, its main
    # path).
    for kw in (dict(),
               dict(heads=MOE_HEADS, tag="_d64"),
               dict(heads=MINI_HEADS, shapes=((1, 1024), (2, 1000), (2, 200)),
                    train=(1, 1024), tag="_mini"),
               dict(heads=LLAMA8B_HEADS, shapes=((2, 4096),),
                    dtypes=(torch.bfloat16,), train=(2, 4096), tag="_8b")):
        for key, e in flash_bwd_checks(tol, device, **kw).items():
            errs[key] = max(errs.get(key, 0.0), e)
    if device == "cuda":
        head_dim_refused()
    return errs


def head_dim_refused():
    """A CUDA tensor of a head size the kernels are not built for (96)
    raises in the three wrappers, and the C entry points refuse it too."""
    # The modules, not the functions the package re-exports under their
    # names.
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    pa = importlib.import_module("ray_tpu_torch.ops.paged_attention")
    q = torch.zeros((1, 128, 2, 96), dtype=torch.bfloat16, device="cuda")
    lse = torch.zeros((2, 1, 128), device="cuda")
    pq = torch.zeros((2, 1, 8, 96), dtype=torch.bfloat16, device="cuda")
    pool = torch.zeros((3, 2, 64, 96), dtype=torch.bfloat16, device="cuda")
    tables = torch.ones((2, 2), dtype=torch.int32, device="cuda")
    pos = torch.zeros((2,), dtype=torch.int32, device="cuda")
    for call in (lambda: fa.flash_attention_forward(q, q, q),
                 lambda: fa.flash_attention_backward(q, q, q, q, lse, q),
                 lambda: pa.paged_attention(pq, pool, pool, tables, pos)):
        try:
            call()
        except ValueError as e:
            check("head_dim" in str(e), f"head_dim 96 refused for {e}")
        else:
            raise SmokeFailure("a head_dim 96 CUDA tensor was not refused")
    stream = torch.cuda.current_stream().cuda_stream
    err = fa._kernel()(1, *(q.data_ptr(),) * 4, lse.data_ptr(), 1, 128, 2,
                       2, 96, 1, stream)
    check(err != 0, "rtt_flash_fwd accepted head_dim 96")
    ws = torch.zeros((4096,), dtype=torch.float32, device="cuda")
    p_err = pa._kernel()(1, pq.data_ptr(), pool.data_ptr(), pool.data_ptr(),
                         tables.data_ptr(), pos.data_ptr(), pq.data_ptr(),
                         ws.data_ptr(), ws.data_ptr(), ws.data_ptr(), 2, 1, 8,
                         2, 96, 64, 2, 4, 1, 96**-0.5, stream)
    check(p_err != 0, "rtt_paged_attention accepted head_dim 96")
    print(f"  head_dim 96: the three wrappers raise, rtt_flash_fwd returns "
          f"{err}, rtt_paged_attention {p_err}")
    # The C entry point refuses a split that is not whole stages (page 4:
    # 16 pages per stage; page 12: 5) and a page size of 0; the wrapper
    # takes every page size (phase 1's cases).
    pq = torch.zeros((2, 1, 8, 128), dtype=torch.bfloat16, device="cuda")
    pool = torch.zeros((3, 2, 4, 128), dtype=torch.bfloat16, device="cuda")
    codes = []
    for page, pps in ((4, 3), (12, 4), (16, 3), (0, 1)):
        codes.append(pa._kernel()(
            1, pq.data_ptr(), pool.data_ptr(), pool.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), pq.data_ptr(), ws.data_ptr(),
            ws.data_ptr(), ws.data_ptr(), 2, 1, 8, 2, 128, page, 2, 4, pps,
            128**-0.5, stream))
    check(all(c != 0 for c in codes),
          f"rtt_paged_attention accepted a split of part of a stage or a "
          f"page of 0 tokens: {codes}")
    print(f"  rtt_paged_attention returns {codes} for page 4 with 3 pages "
          f"per split, 12 with 4, 16 with 3 (not whole stages) and page 0")


def flash_inputs(b, s, dtype, seed, h=8, hkv=4, d=128, device="cuda"):
    """q, k, v and a gradient dO (by default at the bench preset's head
    layout), drawn on the device from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d))
    return [torch.randn(sh, generator=g, device=device).to(dtype)
            for sh in shapes]


# (query heads, KV heads, head_dim): the bench preset, moe_bench, mini
# (served paged and dense) and llama3_8b (served, and the bench_8b.py
# recipe).
BENCH_HEADS, MOE_HEADS, LLAMA8B_HEADS = (8, 4, 128), (16, 8, 64), (32, 8, 128)
MINI_HEADS = (12, 4, 64)
# Shapes (B, S) of the flash checks: the training step's 16 x 2048, a
# ragged last tile (1000), a ragged second 128-row tile (200) and less
# than one tile (64).
FLASH_SHAPES = ((16, 2048), (2, 1000), (2, 512), (2, 200), (2, 64))


def flash_bwd_checks(tol, device="cuda", heads=BENCH_HEADS,
                     shapes=FLASH_SHAPES, dtypes=(torch.bfloat16,
                                                  torch.float32),
                     train=(16, 2048), tag="", oracle=False):
    """At one head layout (by default the bench preset's 8 query, 4 KV
    heads of 128): the forward kernel's O and LSE against its plain
    version, then dq, dk, dv of the backward kernel against its plain
    version on those same O and LSE, at the flash tolerances of phase 1
    (bf16: ``FLASH_BF16_TOL`` per element and ``FLASH_BF16_NORM``; fp32:
    1e-4, the same arithmetic in another summation order). With
    ``oracle`` (phase 8a) the bf16 O, dq, dk and dv are held instead to
    the plain versions in fp32 on the same bf16 inputs
    (``FLASH_ORACLE_TOL``, ``FLASH_ORACLE_NORM``), and the plain bf16
    versions' own distance from them is printed beside.

    The bf16 backward sums dq with fp32 atomics in no fixed order: it
    runs a second time on the same inputs, and the largest |ddq| between
    the two runs must stay within 2^-8 * max |dq| (fp32 sums in two
    orders, each rounded once to bf16, differ by at most one bf16 step).

    Returns the worst bf16 errors, each key ending in ``tag``:
    "flash_train" (forward O at the shape ``train``), "flash" (forward O
    at the other shapes) and "flash_bwd" (dq, dk, dv at every shape), and
    "dq_spread" (the largest run-to-run |ddq|)."""
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_backward,
        flash_attention_backward_reference,
        flash_attention_forward,
        flash_attention_reference,
    )

    h, hkv, d = heads
    worst = {f"flash_train{tag}": 0.0, f"flash{tag}": 0.0,
             f"flash_bwd{tag}": 0.0, "dq_spread": 0.0}
    for dtype in dtypes:
        bf16 = dtype == torch.bfloat16
        atol, rtol = tol[dtype]
        norm = FLASH_BF16_NORM if bf16 else None
        if bf16 and oracle:
            (atol, rtol), norm = FLASH_ORACLE_TOL, FLASH_ORACLE_NORM
        for b, s in shapes:
            q, k, v, do = flash_inputs(b, s, dtype, seed=s, h=h, hkv=hkv,
                                       d=d, device=device)
            fwd_key = ("flash_train" if (b, s) == train else "flash") + tag
            for causal in (True, False):
                label = (f"B={b} S={s} H={h}/{hkv} D={d} causal={causal} "
                         f"{str(dtype)[6:]}")
                o, lse = flash_attention_forward(q, k, v, causal)
                o_ref, lse_ref = flash_attention_reference(q, k, v, causal)
                if bf16 and oracle:
                    f32 = [t.float() for t in (q, k, v, do)]
                    o_32, lse_32 = flash_attention_reference(*f32[:3],
                                                             causal)
                sync()
                if bf16 and oracle:
                    e_fwd = compare(f"flash {label} O vs fp32", o, o_32,
                                    atol, rtol, norm)
                    print(f"    plain bf16 O vs fp32: "
                          f"{distance(o_ref, o_32, rtol)}")
                else:
                    e_fwd = compare(f"flash {label} O", o, o_ref, atol, rtol,
                                    norm)
                compare(f"flash {label} LSE", lse, lse_ref, 1e-4, 1e-4)
                del o_ref, lse_ref
                got = flash_attention_backward(q, k, v, o, lse, do, causal)
                want = flash_attention_backward_reference(
                    q, k, v, o, lse, do, causal
                )
                sync()
                if bf16 and oracle:
                    exact = flash_attention_backward_reference(
                        *f32[:3], o_32, lse_32, f32[3], causal)
                    del f32, o_32, lse_32
                    e_bwd = 0.0
                    for name, a, w, x in zip(("dq", "dk", "dv"), got, want,
                                             exact):
                        e_bwd = max(e_bwd, compare(
                            f"flash bwd {label} {name} vs fp32", a, x, atol,
                            rtol, norm))
                        print(f"    plain bf16 {name} vs fp32: "
                              f"{distance(w, x, rtol)}")
                    del exact
                else:
                    e_bwd = max(
                        compare(f"flash bwd {label} {name}", a, w, atol,
                                rtol, norm)
                        for name, a, w in zip(("dq", "dk", "dv"), got, want)
                    )
                if bf16:
                    worst[fwd_key] = max(worst[fwd_key], e_fwd)
                    worst["flash_bwd" + tag] = max(worst["flash_bwd" + tag],
                                                   e_bwd)
                    again = flash_attention_backward(q, k, v, o, lse, do,
                                                     causal)[0]
                    spread = float((again.float() - got[0].float()).abs()
                                   .max())
                    limit = 2**-8 * float(got[0].float().abs().max())
                    print(f"  flash bwd {label} dq run to run: max |ddq| "
                          f"{spread:.3e} (limit {limit:.3e})")
                    check(spread <= limit,
                          f"flash bwd {label}: dq moves {spread:.3e} run to "
                          f"run, more than one bf16 step")
                    worst["dq_spread"] = max(worst["dq_spread"], spread)
                    del again
                del got, want
    return worst


# ------------------------------------------------------------ main path
def reset_counts():
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )
    from ray_tpu_torch.ops.paged_attention import paged_attention

    paged_attention.launches = 0
    flash_attention_forward.launches = 0
    flash_attention_backward.launches = 0


def counts():
    """Launches since reset_counts: (paged, flash forward, flash
    backward)."""
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )
    from ray_tpu_torch.ops.paged_attention import paged_attention

    return (paged_attention.launches, flash_attention_forward.launches,
            flash_attention_backward.launches)


def serve(engine, prompts, sampling):
    """Submit all prompts, step to completion; returns (outputs, step
    wall times, tokens emitted per step, finished dicts)."""
    order = {engine.add_request(p, sampling): i
             for i, p in enumerate(prompts)}
    outs = [None] * len(prompts)
    fins = []
    step_s, step_tokens = [], []
    while engine.has_unfinished():
        before = engine.stats()["tokens_generated"]
        t0 = time.perf_counter()
        for fin in engine.step():
            outs[order[fin["request_id"]]] = fin["tokens"]
            fins.append(fin)
        sync()
        step_s.append(time.perf_counter() - t0)
        step_tokens.append(engine.stats()["tokens_generated"] - before)
    return outs, step_s, step_tokens, fins


def logits_tolerance(name, got, want):
    """bf16 logits after 32 layers: the kernel and the plain path round
    attention outputs at different places, so allow 5% of the logits'
    range and require the same argmax where the top-2 gap exceeds it."""
    scale = float(want.abs().max())
    atol = 0.05 * scale
    compare(name, got, want, atol, 0.0)
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * atol
    same = got.argmax(-1) == want.argmax(-1)
    check(bool(same[clear].all()), f"{name}: argmax differs on a clear row")


SERVE_LENGTHS = (20, 63, 64, 65, 200, 511, 900, 1500)


def serving_prompts(cfg, rng, lengths=SERVE_LENGTHS):
    """Phase 2's prompts: one of each length, token ids drawn from
    ``rng``."""
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]


def phase2(cfg, params, seed, device="cuda", max_seq=2048, page_size=64,
           lengths=SERVE_LENGTHS, max_tokens=32, name="llama3_8b"):
    """Paged serving of ``cfg``: plain greedy, then speculative; every
    emitted token of both is held to the plain path's greedy choice
    (:func:`stream_check`)."""
    from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
    from ray_tpu_torch.llm.paged_kv import paged_decode

    print(f"phase 2: paged engine, {name}")
    rng = np.random.default_rng(seed)
    prompts = serving_prompts(cfg, rng, lengths)
    sp = SamplingParams(max_tokens=max_tokens)
    eng = LLMEngine(cfg, max_batch=8, max_seq=max_seq, params=params,
                    kv="paged", page_size=page_size, seed=seed,
                    device=device)
    check(eng.paged_attn_kernel, "paged engine did not select the kernel")
    rec = {}
    decode = eng._decode_paged

    def recording(params, tokens, pool, tables, positions, temps, gen):
        out = decode(params, tokens, pool, tables, positions, temps, gen)
        if not rec:
            rec.update(tokens=tokens.clone(), tables=tables.clone(),
                       positions=positions.clone(), temps=temps.clone(),
                       logits=out[1].clone())
        return out

    # Warm-up pass (cuBLAS picks its kernels per shape on first use), so
    # the measured pass times the steady state.
    serve(eng, prompts, SamplingParams(max_tokens=2))
    eng._decode_paged = recording
    steps0 = eng.stats()["decode_steps"]
    reset_counts()
    outs, step_s, step_tokens, fins = serve(eng, prompts, sp)
    p_launch, f_launch, _ = counts()
    st = eng.stats()
    steps = st["decode_steps"] - steps0
    check(all(o is not None and len(o) == max_tokens for o in outs),
          "a paged request did not finish with max_tokens tokens")
    check(p_launch == cfg.n_layers * steps,
          f"paged kernel launched {p_launch} times for "
          f"{steps} decode steps x {cfg.n_layers} layers")
    check(st["active_requests"] == 0 and st["pages_free"] == st["pages_total"],
          "paged engine leaked slots or pages")
    # All 8 requests are admitted in the first step; the rest are decode.
    decode_tps = sum(step_tokens[1:]) / sum(step_s[1:])
    ttft = [f["timing"]["ttft_s"] for f in fins]

    # The first decode step again, through the plain gather path.
    g = torch.Generator(device=device).manual_seed(seed)
    _s, plain_logits, _p = paged_decode(
        eng.params, rec["tokens"], eng.cache, rec["tables"],
        rec["positions"], rec["temps"], g, cfg=cfg, use_kernel=False,
    )
    logits_tolerance("first decode step logits, kernel vs plain",
                     rec["logits"], plain_logits)
    check(bool(torch.isfinite(plain_logits).all()), "non-finite logits")
    profile_decode(eng, prompts, sum(step_s[1:]) / len(step_s[1:]))
    del eng

    # Speculative decoding on repetitive prompts.
    pattern = rng.integers(0, cfg.vocab_size, 12).tolist()
    spec_prompts = [(pattern * (n // 12 + 1))[: max(n, 24)]
                    for n in lengths]
    spec = LLMEngine(cfg, max_batch=8, max_seq=max_seq, params=params,
                     kv="paged", page_size=page_size, seed=seed,
                     speculate=3, device=device)
    reset_counts()
    spec_outs, spec_s, spec_tokens, _ = serve(spec, spec_prompts, sp)
    p_spec, _, _ = counts()
    st_spec = spec.stats()
    profile_decode(spec, spec_prompts, sum(spec_s[1:]) / len(spec_s[1:]),
                   label="verify")
    check(all(o is not None and len(o) == max_tokens for o in spec_outs),
          "a speculative request did not finish")
    check(p_spec == cfg.n_layers * st_spec["decode_steps"],
          f"paged kernel launched {p_spec} times for "
          f"{st_spec['decode_steps']} verify steps x {cfg.n_layers} layers")
    del spec
    stream_check(cfg, params, prompts, outs, "greedy", device)
    stream_check(cfg, params, spec_prompts, spec_outs, "speculative", device)
    prefix_pages_check(cfg, params, prompts[-1], seed, device)
    print(f"  greedy: {steps} decode steps, "
          f"{p_launch} kernel launches; speculative: "
          f"{st_spec['decode_steps']} verify steps, {p_spec} launches, "
          f"acceptance {st_spec.get('draft_acceptance_rate', 0.0)}")
    return {
        "launches": p_launch + p_spec,
        "greedy_launches": (p_launch, f_launch),
        "prompts": prompts,
        "outs": outs,
        "decode_tokens_per_s": decode_tps,
        "ttft_s_mean": float(np.mean(ttft)),
        "ttft_s_max": float(np.max(ttft)),
        "spec_tokens_per_s": sum(spec_tokens[1:]) / sum(spec_s[1:]),
        "first_positions": rec["positions"].cpu().tolist(),
    }


def stream_check(cfg, params, prompts, outs, label, device="cuda"):
    """Each served token stream against the plain path, teacher-forced:
    prompt + stream through the plain dense prefill (no kernel) in one
    pass; at every position the emitted token must be the plain argmax up
    to the bf16 tolerance of logits_tolerance (its logit within 2 x 5% of
    the logits' range of the row's max), so a stream equals the plain
    path's wherever the plain path's choice is clear. Prints how many
    tokens are its exact argmax."""
    from ray_tpu_torch.llm.kv_cache import forward_prefill, init_kv_cache

    exact = total = 0
    for prompt, out in zip(prompts, outs):
        toks = list(prompt) + list(out[:-1])
        cache = init_kv_cache(cfg, 1, len(toks), device)
        logits, _ = forward_prefill(
            params, torch.tensor([toks], device=device), cache, 0, cfg,
            use_flash=False,
        )
        z = logits[0, len(prompt) - 1:].float()  # row i predicts out[i]
        atol = 0.05 * float(z.abs().max())
        chosen = z.gather(1, torch.tensor(out, device=device)[:, None])[:, 0]
        ok = chosen >= z.max(dim=-1).values - 2 * atol
        check(bool(ok.all()), f"{label} stream: a token is not the plain "
              f"path's choice at positions {(~ok).nonzero().tolist()}")
        exact += int((z.argmax(-1) == torch.tensor(out, device=device))
                     .sum())
        total += len(out)
        del cache, logits
    print(f"  {label} streams vs the plain path (teacher-forced): "
          f"{total} tokens within tolerance, {exact} its exact argmax")


def page_variants(cfg, params, seed, p2, pages, name, max_seq=2048):
    """Phase 2's greedy pass again on paged engines of smaller pages
    (P1 walks floor(64 / P) pages per stage): each page size's P1
    launches must be one per layer per decode step, no page may leak, and
    every stream is held to the plain path (stream_check); how many
    streams equal the 64-token run's is printed (bf16 rounds differently
    along another page walk, so a near-tie may flip)."""
    from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams

    out = {}
    max_tokens = len(p2["outs"][0])
    for page in pages:
        eng = LLMEngine(cfg, max_batch=8, max_seq=max_seq, params=params,
                        kv="paged", page_size=page, seed=seed, device="cuda")
        check(eng.paged_attn_kernel, "paged engine did not select the kernel")
        serve(eng, p2["prompts"], SamplingParams(max_tokens=2))  # warm-up
        steps0 = eng.stats()["decode_steps"]
        reset_counts()
        outs, step_s, step_tokens, _ = serve(
            eng, p2["prompts"], SamplingParams(max_tokens=max_tokens))
        launches = counts()[0]
        st = eng.stats()
        steps = st["decode_steps"] - steps0
        check(all(o is not None and len(o) == max_tokens for o in outs),
              f"a page-{page} request did not finish")
        check(launches == cfg.n_layers * steps,
              f"page {page}: P1 launched {launches} times for {steps} "
              f"decode steps x {cfg.n_layers} layers")
        check(st["active_requests"] == 0
              and st["pages_free"] == st["pages_total"],
              f"page-{page} engine leaked slots or pages")
        same = sum(a == b for a, b in zip(outs, p2["outs"]))
        del eng
        stream_check(cfg, params, p2["prompts"], outs,
                     f"{name} greedy, page {page}")
        tps = sum(step_tokens[1:]) / sum(step_s[1:])
        print(f"  {name} page {page}: {steps} decode steps, {launches} P1 "
              f"launches, {same} of {len(outs)} streams equal the 64-token "
              f"run's, decode {tps:.1f} tokens/s")
        out[page] = {"launches": launches, "same": same, "tps": tps}
    return out


def profile_decode(engine, prompts, step_wall_s, n_steps=4, label="decode"):
    """Print the device time of a few steady decode (or, on a speculative
    engine, verify) steps by kernel class, from a torch.profiler trace,
    against the unprofiled step's wall time."""
    from ray_tpu_torch.llm.engine import SamplingParams
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        engine.add_request(p, SamplingParams(max_tokens=n_steps + 2))
    engine.step()  # admissions and the first decode stay outside
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            engine.step()
        sync()
    while engine.has_unfinished():
        engine.step()
    classes = {"paged_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side events; kernels and copies are CUDA
        name = ev.key.lower()
        if "paged_attention_kernel" in name:
            cls = "paged_attention"
        elif any(t in name for t in ("gemm", "gemv", "cutlass", "nvjet",
                                      "xmma", "cublas")):
            cls = "matmul"
        else:
            cls = "other"
        classes[cls] += ev.self_device_time_total  # microseconds
    per_step = {k: v / n_steps / 1e3 for k, v in classes.items()}  # ms
    busy = sum(per_step.values())
    print(f"  profiled {label} step (batch 8): device "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in per_step.items())
          + f"; device busy {busy:.2f} ms of {step_wall_s * 1e3:.2f} ms "
          f"wall ({busy / (step_wall_s * 1e3):.1%})")


def prefix_pages_check(cfg, params, prompt, seed, device="cuda",
                       page_size=64):
    """Admit A (130 tokens: two full pages), then B, which shares A's two
    full pages but is prefilled in another bucket (528 tokens). The same
    tokens prefilled at two bucket lengths need not give byte-identical
    K/V on the card (cuBLAS may tile the two products differently), so
    the engine must not write the pages B shares: check that A's shared
    pages are byte-identical before and after B's admission."""
    from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams

    eng = LLMEngine(cfg, max_batch=2, max_seq=2048, params=params,
                    kv="paged", page_size=page_size, seed=seed,
                    device=device)
    sp = SamplingParams(max_tokens=8)
    eng.add_request(prompt[:130], sp)
    eng.step()
    (req_a,) = eng._active.values()
    shared = req_a.pages[:2]
    before = {n: eng.cache[n][:, shared].clone() for n in ("k", "v")}
    eng.add_request(prompt[:128] + prompt[200:600], sp)
    eng.step()
    sync()
    check(len(eng._active) == 2, "the second request was not admitted")
    req_b = next(r for r in eng._active.values() if r is not req_a)
    check(req_b.pages[:2] == shared,
          "the second request does not share the prefix pages")
    same = all(torch.equal(eng.cache[n][:, shared], before[n])
               for n in ("k", "v"))
    print(f"  shared-prefix pages of a live request after a second "
          f"admission (bucket 256 vs 1024): "
          f"{'byte-identical' if same else 'REWRITTEN'}")
    check(same, "admitting a request rewrote a live request's shared pages")
    while eng.has_unfinished():
        eng.step()


def phase3(cfg, params, seed, device="cuda", max_seq=2048, prompt_len=1024,
           max_tokens=32, name="llama3_8b"):
    from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
    from ray_tpu_torch.llm.kv_cache import forward_prefill, init_kv_cache

    print(f"phase 3: dense engine, {name}")
    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, cfg.vocab_size, prompt_len).tolist()
    eng = LLMEngine(cfg, max_batch=1, max_seq=max_seq, params=params,
                    kv="dense", seed=seed, device=device)
    rec = {}
    prefill = eng._prefill

    def recording(params, tokens, cache, slot):
        out = prefill(params, tokens, cache, slot)
        rec.update(tokens=tokens.clone(), logits=out[0].clone())
        return out

    eng._prefill = recording
    reset_counts()
    outs, _step_s, _tok, fins = serve(
        eng, [prompt], SamplingParams(max_tokens=max_tokens)
    )
    _, f_launch, _ = counts()
    check(outs[0] is not None and len(outs[0]) == max_tokens,
          "the dense request did not finish")
    check(f_launch == cfg.n_layers,
          f"flash kernel launched {f_launch} times in one prefill of "
          f"{cfg.n_layers} layers")
    del eng
    plain_logits, _ = forward_prefill(
        params, rec["tokens"], init_kv_cache(cfg, 1, max_seq, device),
        0, cfg, use_flash=False,
    )
    logits_tolerance("prefill logits, flash kernel vs plain",
                     rec["logits"][0, :prompt_len],
                     plain_logits[0, :prompt_len])
    return {"launches": f_launch, "ttft_s": fins[0]["timing"]["ttft_s"],
            "prompt": prompt, "out": outs[0]}


# ------------------------------------------------------------ training
def rel_err(got, want):
    """||got - want|| / ||want||, in fp32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def grad_step_checks(cfg, params, tokens):
    """One gradient step through the flash kernels against one through
    the plain dense attention (under which "flash_qkv" acts as "full"), on
    the same weights and tokens, in fp32 and in bf16 compute: the loss,
    the gradient norm and every leaf's gradient, as relative (Frobenius)
    errors.

    fp32: the two differ in summation order only: <= 1e-3.
    bf16: the two round attention's probabilities, outputs and gradients
    to bf16 at different places (2^-8 each) through 24 layers, so each is
    held against the fp32 dense gradient instead: the kernels' error may
    be at most twice the plain path's, plus 1e-3."""
    from ray_tpu_torch.ops.flash_attention import make_flash_attention
    from ray_tpu_torch.train.step import _flatten, global_norm, grad_step

    batch = {"tokens": tokens}
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, dtype=dtype)
        for path, attn_cfg, attn_fn in (
            ("kernels", c, make_flash_attention()),
            ("dense", dataclasses.replace(c, attn_impl="dense"), None),
        ):
            m, g = grad_step(attn_cfg, attn_fn)(params, batch)
            vals = {"loss": m["loss"], "grad_norm": global_norm(g)}
            vals.update(("/".join(p), t) for p, t in _flatten(g))
            runs[path, dtype] = vals
    sync()

    def errs(a, b):
        return {k: rel_err(runs[a][k], runs[b][k]) for k in runs[a]}

    f32, bf16 = torch.float32, torch.bfloat16
    ref = ("dense", f32)
    tight = errs(("kernels", f32), ref)
    kern, plain = errs(("kernels", bf16), ref), errs(("dense", bf16), ref)
    direct = errs(("kernels", bf16), ("dense", bf16))
    slack = {k: kern[k] - 2 * plain[k] for k in kern}
    for label, e, worst, ok in (
        ("fp32, kernels vs plain dense", tight, max(tight, key=tight.get),
         all(v <= 1e-3 for v in tight.values())),
        ("bf16, kernels vs fp32 dense", kern, max(slack, key=slack.get),
         all(v <= 1e-3 for v in slack.values())),
    ):
        ok = ok and all(math.isfinite(v) for v in e.values())
        print(f"  grad step B={tokens.shape[0]} {label}: worst {worst} "
              f"{e[worst]:.3e} {'ok' if ok else 'FAIL'}")
        check(ok, f"grad step {label}: {worst} off by {e[worst]:.3e}")
    worst = max(direct, key=direct.get)
    losses = [float(runs[path, bf16]["loss"]) for path in ("kernels", "dense")]
    print(f"  bf16 plain dense vs fp32 dense: worst {max(plain.values()):.3e}"
          f"; bf16 kernels vs bf16 plain dense: worst {worst} "
          f"{direct[worst]:.3e}; loss {losses[0]:.6f} vs {losses[1]:.6f}")
    return direct[worst]


def profile_train(step, state, data, step_s):
    """Device time of one steady train step by kernel class, from a
    torch.profiler trace, against the unprofiled step's wall time. The
    classes are _private/kernel_profile.py's: its attention kernels split
    into F1 and F2, its matmul class less them, and the rest "other"."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch._private import kernel_profile as kp

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, data)
        sync()
    classes = {"flash_fwd": 0.0, "flash_bwd": 0.0, "matmul": 0.0,
               "other": 0.0}
    others, flash = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        cat = kp.categorize_kernel_name(ev.key)
        if cat is None:
            continue
        ms = ev.self_device_time_total / 1e3
        # F1 and F2 by prefix, whatever the kernel (bf16 or fp32 route;
        # F2's preprocess, main and convert kernels).
        kernel = re.search(r"flash_(fwd|bwd)\w*kernel", ev.key.lower())
        if kp.is_attention_kernel(ev.key) and kernel:
            cls = f"flash_{kernel.group(1)}"
            flash[kernel.group(0)] = flash.get(kernel.group(0), 0.0) + ms
        elif cat == "matmul":
            cls = "matmul"
        else:
            cls = "other"
            others[ev.key[:60]] = ms
        classes[cls] += ms
    busy = sum(classes.values())
    wall = step_s * 1e3
    check(classes["flash_fwd"] > 0 and classes["flash_bwd"] > 0,
          f"the profile finds no F1 or F2 time: {classes}")
    print("  flash kernels in the profile: "
          + "; ".join(f"{k} {v:.1f} ms" for k, v in sorted(flash.items())))
    print("  profiled train step: device "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in classes.items())
          + f"; busy {busy:.1f} ms of {wall:.1f} ms wall, idle "
          f"{1 - busy / wall:.1%}")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
    print("  largest of 'other': "
          + "; ".join(f"{k} {v:.1f} ms" for k, v in top))
    return state, dict(classes, busy=busy, idle_share=1 - busy / wall)


# One captured step: the device time per step is steady (profile_train
# reads one too), and the profiler's post-processing of a bench step's
# events takes seconds per step. Phase 4's state is warm: no warm-up.
P4_CAPTURE_STEPS = 1


def capture_train(cfg, opt, state, data, batch, seq, step_s):
    """train/profile.py's profile_train_step on phase 4's state and batch:
    P4_CAPTURE_STEPS captured steps; its attribution report's checks, and
    the split of its elementwise class by kernel (all kernels' ms go to
    OUT_DIR/p4_capture.json)."""
    from ray_tpu_torch._private import kernel_profile as kp
    from ray_tpu_torch.train import profile

    t0 = time.perf_counter()
    rep = profile.profile_train_step(
        cfg, batch_size=batch, seq=seq, steps=P4_CAPTURE_STEPS, warmup=0,
        device="cuda", state=state, optimizer=opt, batch=data)
    took = time.perf_counter() - t0
    m, n = rep["measured"], rep["steps"]
    card = card_line()
    shares = rep["shares"]
    print(f"  capture (profile_train_step, {n} steps, {took:.1f} s with its "
          f"warm-up and trace export): step {rep['step_s'] * 1e3:.1f} ms "
          f"(unprofiled {step_s * 1e3:.1f} ms), mfu {rep['mfu']:.4f}; "
          "shares " + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
          + f"; dominant gap {rep['dominant_gap']} [{card}]")
    print("  capture, device ms per step: "
          + ", ".join(f"{k} {v * 1e3 / n:.1f}"
                      for k, v in m["categories"].items())
          + f"; attention kernels {m['attention_ms'] / n:.1f}; busy "
          f"{m['device_busy_s'] * 1e3 / n:.1f}")
    for cat in ("elementwise_fusion", "layout"):
        print(f"  capture, largest of {cat}, ms per step: "
              + "; ".join(f"{kp.brief(k)} {v / n:.2f}"
                          for k, v in kp.largest(m, cat, 8)))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "p4_capture.json"), "w") as f:
        json.dump({"card": card, "steps": n, "report": {
            k: rep[k] for k in ("shares", "seconds", "step_s", "mfu",
                                "dominant_gap")},
            "measured": m}, f, indent=1)
    check(abs(sum(shares.values()) - 1.0) <= 0.10,
          f"4: the capture's shares sum to {sum(shares.values()):.4f}")
    check(rep["dominant_gap"] != "compute_floor" and rep["mfu"] > 0,
          f"4: dominant gap {rep['dominant_gap']}, mfu {rep['mfu']}")
    check(rep["seconds"]["compute_floor"] <= rep["step_s"],
          f"4: compute floor {rep['seconds']['compute_floor']} s above the "
          f"step's {rep['step_s']} s")
    check(m["categories"]["matmul"] > 0 and m["attention_ms"] > 0,
          f"4: the capture's matmul class {m['categories']}")
    return rep["state"], {
        "shares": shares, "dominant": rep["dominant_gap"], "mfu": rep["mfu"],
        "step_ms": rep["step_s"] * 1e3, "took_s": took,
        "ms": {k: v * 1e3 / n for k, v in m["categories"].items()},
        "attention_ms": m["attention_ms"] / n,
        "elementwise": [(kp.brief(k), v / n) for k, v in
                        kp.largest(m, "elementwise_fusion", 8)]}


def time_ce_and_optimizer(cfg, opt, state, batch, seq):
    """The chunked cross-entropy (forward + backward, from random hidden
    states) and one optimizer update (zero gradients: the same work), each
    timed alone with CUDA events."""
    from ray_tpu_torch.train.step import (
        _flatten,
        _unflatten,
        chunked_cross_entropy,
    )

    g = torch.Generator(device="cuda").manual_seed(3)
    hidden = torch.randn((batch, seq, cfg.d_model), generator=g,
                         device="cuda").to(cfg.dtype).requires_grad_()
    head = state.params["lm_head"]
    targets = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                            device="cuda")

    def ce():
        loss = chunked_cross_entropy(hidden, head, targets, cfg.dtype)
        torch.autograd.grad(loss, (hidden, head))

    ce_ms = time_ms(ce, iters=5, warmup=1)
    grads = _unflatten((path, torch.zeros_like(t))
                       for path, t in _flatten(state.params))
    opt_ms = time_ms(lambda: opt.apply(state.params, grads, state.opt_state),
                     iters=5, warmup=1)
    print(f"  timed alone: chunked CE forward + backward {ce_ms:.1f} ms, "
          f"optimizer update {opt_ms:.1f} ms")
    return ce_ms, opt_ms


def train_run(cfg, seed, device, batch, seq, warmup, steps, f1, f2, label):
    """``warmup`` + ``steps`` train steps of ``cfg`` (fp32 parameters from
    ``seed``, AdamW with a bf16 first moment) on one batch of ``batch`` x
    ``seq + 1`` tokens drawn from the seed, each ending in a sync; every
    step must launch the flash forward ``f1`` and the backward ``f2``
    times. Returns the state, the step function, the batch, per-step
    losses (and MoE aux losses), the mean timed step, its tokens/s, the
    peak memory of the timed steps and the launches of all steps."""
    from ray_tpu_torch.train.step import (
        init_train_state,
        jit_train_step,
        make_optimizer,
    )

    opt = make_optimizer(total_steps=1000, mu_dtype=torch.bfloat16)
    state = init_train_state(cfg, opt, seed=seed, device=device)
    step = jit_train_step(cfg, opt)
    rng = np.random.default_rng(seed)
    data = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq + 1))).to(device)}
    losses, aux, norms, wall = [], [], [], []
    launches = [0, 0]
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats()  # allocated and reserved
        reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, data)
        sync()
        dt = time.perf_counter() - t0
        _, n1, n2 = counts()
        check(n1 == f1 and n2 == f2,
              f"{label} step {i}: {n1} forward and {n2} backward flash "
              f"launches, expected {f1} and {f2}")
        launches[0] += n1
        launches[1] += n2
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if "aux_loss" in m:
            aux.append(float(m["aux_loss"]))
        if i >= warmup:
            wall.append(dt)
        print(f"  step {i}: loss {losses[-1]:.4f}"
              + (f", aux_loss {aux[-1]:.5f}" if aux else "")
              + f", grad_norm {norms[-1]:.4f}, {dt * 1e3:.1f} ms, flash "
              f"launches {n1} + {n2}")
    check(all(math.isfinite(x) for x in losses + norms + aux),
          f"{label}: a loss or gradient norm is not finite")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 0.5,
          f"{label}: step 0 loss {losses[0]:.4f} is not within 0.5 of "
          f"ln {cfg.vocab_size} = {math.log(cfg.vocab_size):.4f}")
    step_s = sum(wall) / len(wall)
    peak = torch.cuda.max_memory_allocated()
    return dict(state=state, step=step, data=data, opt=opt, losses=losses,
                aux=aux, step_s=step_s, tps=batch * seq / step_s, peak=peak,
                slack=torch.cuda.max_memory_reserved() - peak,
                launches=launches)


def phase4(seed, device="cuda", batch=16, seq=2048, warmup=2, steps=4):
    from ray_tpu_torch.models.llama import PRESETS

    print("phase 4: training, bench preset")
    cfg = dataclasses.replace(PRESETS["bench"], attn_impl="flash")
    n = cfg.n_layers
    r = train_run(cfg, seed, device, batch, seq, warmup, steps, n, n,
                  "remat flash_qkv")
    state, step, data, opt = r["state"], r["step"], r["data"], r["opt"]
    step_s, tps, peak = r["step_s"], r["tps"], r["peak"]
    share = tps * cfg.flops_per_token(seq) / BF16_FLOPS
    print(f"  train: {tps:.1f} tokens/s ({step_s * 1e3:.1f} ms per step of "
          f"{batch} x {seq} tokens, {cfg.flops_per_token(seq) / 1e9:.3f} "
          f"GFLOP/token), {share:.2%} of the dense bf16 peak; peak memory "
          f"{peak / 2**30:.2f} GiB")

    modes = remat_modes(cfg, state.params, data)
    state, prof = profile_train(step, state, data, step_s)
    state, capture = capture_train(cfg, opt, state, data, batch, seq, step_s)
    ce_ms, opt_ms = time_ce_and_optimizer(cfg, opt, state, batch, seq)
    # The same weights through the kernels and through the plain dense
    # attention, at batch 2 (the dense path keeps [B, H, S, S] scores).
    grad_err = grad_step_checks(cfg, state.params, data["tokens"][:2])
    return {"cfg": cfg, "f1_launches": r["launches"][0],
            "f2_launches": r["launches"][1], "tokens_per_s": tps,
            "peak_share": share, "step_ms": step_s * 1e3,
            "peak_gib": peak / 2**30,
            "losses": r["losses"], "profile": prof, "capture": capture,
            "ce_ms": ce_ms,
            "opt_ms": opt_ms, "grad_err": grad_err, "modes": modes}


# Flash forward launches per layer in one forward + backward of each remat
# mode (models/llama.py): the modes that keep the flash outputs never
# replay the forward kernel.
F1_PER_LAYER = {"none": 1, "full": 2, "attn": 2, "flash": 1, "dots": 2,
                "flash_qkv": 1, "flash_qkv_ffn": 1, "flash_qkv_ffn8": 1}


def remat_modes(cfg, params, data,
                modes=("flash_qkv", "full", "attn", "flash", "dots",
                       "flash_qkv_ffn", "flash_qkv_ffn8", "none")):
    """Forward + backward (``grad_step``, no optimizer update) of each
    remat mode on the same weights and batch, twice: the second call is
    timed (wall, ending in a sync), the peak memory is that of both, and
    each call must launch F1_PER_LAYER forwards and one backward per
    layer. Every exact mode's loss equals flash_qkv's to 1e-3 relative (the
    same forward operations; bf16 noise); flash_qkv_ffn8's within 2%, the
    reference's bound for its int8 activations (tests/test_model.py)."""
    from ray_tpu_torch.ops.flash_attention import make_flash_attention
    from ray_tpu_torch.train.step import global_norm, grad_step

    n = cfg.n_layers
    out = {}
    for mode in modes:
        fn = grad_step(dataclasses.replace(cfg, remat=mode),
                       make_flash_attention())
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):  # the first call warms the allocator's cache
            reset_counts()
            t0 = time.perf_counter()
            m, grads = fn(params, data)
            sync()
            dt = time.perf_counter() - t0
            _, f1, f2 = counts()
            check(f1 == F1_PER_LAYER[mode] * n and f2 == n,
                  f"remat {mode}: {f1} forward and {f2} backward flash "
                  f"launches for {n} layers, expected "
                  f"{F1_PER_LAYER[mode] * n} and {n}")
            loss, norm = float(m["loss"]), float(global_norm(grads))
            del grads
        peak = torch.cuda.max_memory_allocated()
        out[mode] = dict(ms=dt * 1e3, peak=peak, peak_gib=peak / 2**30, f1=f1,
                         f2=f2, loss=loss, grad_norm=norm,
                         slack=torch.cuda.max_memory_reserved() - peak)
        base = out["flash_qkv"]
        rel = abs(loss - base["loss"]) / base["loss"]
        limit = 2e-2 if mode == "flash_qkv_ffn8" else 1e-3
        print(f"  remat {mode}: forward + backward {dt * 1e3:.1f} ms, peak "
              f"memory {peak / 2**30:.2f} GiB, flash launches {f1} + {f2}, "
              f"loss {loss:.5f} ({rel:.2e} from flash_qkv, limit {limit}),"
              f" grad_norm {norm:.4f}")
        check(math.isfinite(loss) and rel <= limit,
              f"remat {mode}: loss {loss} against flash_qkv's "
              f"{base['loss']}")
    return out


def moe_flops_per_token(cfg, seq):
    """Training FLOPs per token of the MoE model as the dense count does
    it (6 x matmul parameters + the attention term), counting the router
    and the top_k experts a token reaches (the active parameters)."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    per_layer = 2 * d * hq + 2 * d * hkv + d * cfg.num_experts \
        + cfg.top_k * 3 * d * f
    return 6.0 * (L * per_layer + v * d) + 12 * L * d * seq


def moe_oracle_check(cfg, params, device="cuda"):
    """The reference's oracle on the card (tests/test_moe.py): with
    capacity for every token, moe_ffn in fp32 equals the gate-weighted sum
    of each chosen expert's dense SwiGLU FFN, here for layer 0 of the
    moe_bench weights on 64 tokens, at the reference's 2e-3."""
    from ray_tpu_torch.models.moe import moe_ffn

    c = dataclasses.replace(cfg, dtype=torch.float32, capacity_factor=8.0)
    layer = {k: v[0].detach().float() for k, v in params["blocks"].items()}
    g = torch.Generator(device=device).manual_seed(4)
    x = torch.randn((1, 64, c.d_model), generator=g, device=device)
    with torch.no_grad():
        out, _ = moe_ffn(x, layer, c)
        tokens = x[0]
        probs = torch.softmax(tokens @ layer["router"], -1)
        gv, gi = probs.topk(c.top_k, -1)
        gv = gv / gv.sum(-1, keepdim=True)
        want = torch.zeros_like(tokens)
        for t in range(tokens.shape[0]):
            for j in range(c.top_k):
                e, h = int(gi[t, j]), tokens[t]
                act = torch.nn.functional.silu(h @ layer["w_gate"][e]) * (
                    h @ layer["w_up"][e])
                want[t] += gv[t, j] * (act @ layer["w_down"][e])
    compare("moe_ffn fp32 vs the dense top-k ensemble (capacity ample)",
            out[0], want, 2e-3, 2e-3)


def phase5(seed, device="cuda", batch=16, seq=2048, warmup=2, steps=4):
    """MoE training: moe_bench at full width and depth through F1 and F2 at
    head_dim 64."""
    from ray_tpu_torch.models.moe import MOE_PRESETS

    print("phase 5: MoE training, moe_bench preset")
    cfg = dataclasses.replace(MOE_PRESETS["moe_bench"], attn_impl="flash")
    n = cfg.n_layers
    r = train_run(cfg, seed, device, batch, seq, warmup, steps, 2 * n, n,
                  f"MoE remat {cfg.remat}")
    losses, aux = r["losses"], r["aux"]
    check(losses[-1] < losses[0],
          f"MoE loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(len(aux) == len(losses) and min(aux) > 0,
          f"MoE aux loss not positive: {aux}")
    share = r["tps"] * moe_flops_per_token(cfg, seq) / BF16_FLOPS
    print(f"  MoE train: {r['tps']:.1f} tokens/s ({r['step_s'] * 1e3:.1f} ms "
          f"per step of {batch} x {seq} tokens), {share:.2%} of the dense "
          f"bf16 peak at {moe_flops_per_token(cfg, seq) / 1e9:.3f} active "
          f"GFLOP/token; peak memory {r['peak'] / 2**30:.2f} GiB; flash "
          f"launches {r['launches'][0]} + {r['launches'][1]}")
    state, prof = profile_train(r["step"], r["state"], r["data"],
                                r["step_s"])
    moe_oracle_check(cfg, state.params, device)
    return {"cfg": cfg, "f1_launches": r["launches"][0],
            "f2_launches": r["launches"][1], "tokens_per_s": r["tps"],
            "step_ms": r["step_s"] * 1e3, "peak_gib": r["peak"] / 2**30,
            "losses": losses, "aux": aux, "profile": prof,
            "peak_share": share}


def phase6(seed, device="cuda", n_layers=4, batch=2, seq=4096, warmup=2,
           steps=5):
    """The bench_8b.py recipe: 4 full llama3_8b layers (d 4096, 32/8 heads,
    d_ff 14336), vocab 8192, flash attention, remat "full", batch 2 x
    4096 tokens, AdamW with a bf16 first moment."""
    from ray_tpu_torch.train.memory import bench8b_config

    print("phase 6: the bench_8b.py recipe, 4 llama3_8b layers")
    cfg = bench8b_config(n_layers)
    r = train_run(cfg, seed, device, batch, seq, warmup, steps,
                  2 * n_layers, n_layers, "bench_8b")
    per_layer = r["step_s"] * 1e3 / n_layers
    print(f"  bench_8b: {r['tps']:.1f} tokens/s, {r['step_s'] * 1e3:.1f} ms "
          f"per step, {per_layer:.1f} ms per layer, peak memory "
          f"{r['peak'] / 2**30:.2f} GiB ({cfg.num_params() / 1e9:.3f} B "
          f"parameters)")
    return {"tokens_per_s": r["tps"], "per_layer_ms": per_layer,
            "peak": r["peak"], "peak_gib": r["peak"] / 2**30,
            "slack": r["slack"], "losses": r["losses"], "n_layers": n_layers,
            "batch": batch, "seq": seq}


def batch_to_device(batch, device):
    """A TokenDataset batch (host uint32) on the device: viewed as int32
    (ids are below 2^31; the step indexes with them and takes .long() of
    the targets), pinned, copied without blocking on the current
    stream."""
    t = torch.from_numpy(batch["tokens"].view(np.int32))
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return {"tokens": t}


def loop_run(cfg, opt, state, ds, batch, device, start, stop):
    """Steps ``start`` .. ``stop`` - 1 of the training loop: batches from
    ``ds`` (a fresh TokenDataset, so its first epoch; a resumed loop skips
    the ``start`` batches it has trained on), each step ending in a sync.
    Returns the state, the losses and the wall time of each step, from
    asking for the batch to the sync."""
    from ray_tpu_torch.train import jit_train_step

    step = jit_train_step(cfg, opt)
    losses, wall = [], []
    batches = ds.iter_batches(batch)
    for i in range(stop):
        t0 = time.perf_counter()
        host = next(batches)
        if i < start:
            continue
        reset_counts()
        state, m = step(state, batch_to_device(host, device))
        sync()
        wall.append(time.perf_counter() - t0)
        _, n1, n2 = counts()
        check(n1 == n2 == cfg.n_layers,
              f"loop step {i}: {n1} + {n2} flash launches")
        losses.append(float(m["loss"]))
    batches.close()
    return state, losses, wall


def phase7(seed, device="cuda", batch=16, seq=2048, steps=6, save_at=3,
           cfg=None):
    """The single-device training loop on the bench preset at full width
    and depth (24 layers, remat flash_qkv): a token file written from the
    seed, read through TokenDataset (shuffled, prefetched, the ragged tail
    dropped), ``steps`` steps; then again with a CheckpointManager save at
    step ``save_at``, a restore into a fresh state (bit for bit the saved
    one) and the steps after it. The resumed losses must equal the
    uninterrupted ones within one bf16 step (2^-8) relative, the bound
    phase 1 holds the bf16 F2's run-to-run dq spread to (its atomics make
    the card's trajectory not bit-reproducible; the CPU tests hold resume
    bit for bit)."""
    import os
    import tempfile

    from ray_tpu_torch.models.llama import PRESETS
    from ray_tpu_torch.train import (
        CheckpointManager,
        TokenDataset,
        init_train_state,
        make_optimizer,
        train_state_dict,
    )

    print("phase 7: training loop, bench preset (token file, TokenDataset, "
          "checkpoint, resume)")
    cfg = cfg or dataclasses.replace(PRESETS["bench"], attn_impl="flash")
    opt = make_optimizer(lr=3e-4, warmup=1, total_steps=steps,
                         mu_dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "tokens.bin")
        windows = steps * batch + batch // 2  # a ragged tail
        np.random.default_rng(seed).integers(
            0, cfg.vocab_size, size=windows * (seq + 1) + 7, dtype=np.uint32
        ).tofile(path)
        corpus = np.fromfile(path, dtype=np.uint32)

        def dataset():
            return TokenDataset(path, seq, seed=seed)

        ds = dataset()
        check(ds.num_samples == windows, f"{ds.num_samples} windows")
        epoch = [b["tokens"] for b in ds.iter_batches(batch)]
        ds.close()
        check(len(epoch) == steps, f"{len(epoch)} batches, the tail kept")
        # Every row is a distinct window of the file, not in file order.
        index = {w.tobytes(): i for i, w in enumerate(
            corpus[: windows * (seq + 1)].reshape(windows, seq + 1))}
        order = [index.get(row.tobytes(), -1)
                 for e in epoch for row in e]
        check(min(order) >= 0 and len(set(order)) == len(order)
              and order != sorted(order),
              "the batches are not distinct shuffled windows of the file")

        # The uninterrupted run.
        torch.cuda.reset_peak_memory_stats()
        ds = dataset()
        state = init_train_state(cfg, opt, seed=seed, device=device)
        state, want, wall = loop_run(cfg, opt, state, ds, batch, device, 0,
                                     steps)
        ds.close()
        peak = torch.cuda.max_memory_allocated()
        tps = batch * seq * (steps - 1) / sum(wall[1:])
        whole = train_state_dict(state)
        del state
        gc.collect()

        # Train to save_at, save, restore into a fresh state, train on.
        ds = dataset()
        state = init_train_state(cfg, opt, seed=seed, device=device)
        state, got, _ = loop_run(cfg, opt, state, ds, batch, device, 0,
                                 save_at)
        ds.close()
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"), num_to_keep=2)
        sync()
        t0 = time.perf_counter()
        ck_path = mgr.save(state.step, state, metrics={"loss": got[-1]})
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in os.scandir(ck_path))
        fresh = init_train_state(cfg, opt, seed=seed + 1, device=device)
        sync()
        t0 = time.perf_counter()
        where, restored = mgr.restore_latest_valid(target=fresh)
        sync()
        restore_s = time.perf_counter() - t0
        check(where == ck_path and restored.step == save_at
              and restored.opt_state.count == save_at,
              f"restored {where} at step {restored.step}")
        saved, back = train_state_dict(state), train_state_dict(restored)
        check(saved.keys() == back.keys() and all(
            back[k].dtype == saved[k].dtype
            and back[k].device == saved[k].device
            and torch.equal(back[k], saved[k]) for k in saved),
            "the restored state differs from the saved one")
        del state, fresh, saved, back
        gc.collect()
        ds = dataset()
        restored, rest, _ = loop_run(cfg, opt, restored, ds, batch, device,
                                     save_at, steps)
        ds.close()
        check(restored.step == steps, f"resumed run ended at {restored.step}")
        # The two runs' parameters and moments after the last step, each
        # kind as one vector (they differ by the bf16 F2's run-to-run
        # spread only).
        ended = train_state_dict(restored)
        drift = {}
        for kind in ("params", "mu", "nu"):
            keys = [k for k in whole if k.startswith(kind + "/")]
            diff = sum(float((ended[k].float() - whole[k].float()).square()
                             .sum()) for k in keys)
            norm = sum(float(whole[k].float().square().sum()) for k in keys)
            drift[kind] = math.sqrt(diff / norm)
        del restored, ended, whole
    got += rest
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    print("  losses, uninterrupted: " + ", ".join(f"{x:.6f}" for x in want))
    print("  losses, resumed at step "
          f"{save_at}: " + ", ".join(f"{x:.6f}" for x in got)
          + f"; largest relative difference {max(rel):.3e} (before the "
          f"save {max(rel[:save_at]):.3e}; limit 2^-8)")
    print(f"  state after step {steps}, resumed vs uninterrupted, relative "
          f"difference: " + ", ".join(f"{k} {v:.3e}"
                                      for k, v in drift.items()))
    check(all(math.isfinite(x) for x in want + got)
          and abs(want[0] - math.log(cfg.vocab_size)) < 0.5,
          f"loop losses {want} (step 0 not within 0.5 of ln V)")
    check(all(r <= 2**-8 for r in rel),
          "the resumed loss trajectory leaves the uninterrupted one")
    print(f"  checkpoint of the bench state: {nbytes / 1e9:.3f} GB, save "
          f"{save_s:.2f} s ({nbytes / save_s / 1e9:.2f} GB/s), restore "
          f"{restore_s:.2f} s ({nbytes / restore_s / 1e9:.2f} GB/s)")
    print(f"  loop: {tps:.1f} tokens/s through TokenDataset ({batch} x "
          f"{seq} tokens a step, steps 1-{steps - 1}), peak memory "
          f"{peak / 2**30:.2f} GiB")
    return {"cfg": cfg, "tokens_per_s": tps, "save_s": save_s,
            "restore_s": restore_s, "ckpt_bytes": nbytes, "peak": peak,
            "losses": want, "resumed": got, "max_rel": max(rel),
            "drift": drift}


def planner_checks(p4, p6, p7, batch=16, seq=2048):
    """train/memory.py's plan beside each peak it prices, measured in this
    run: the bench preset under remat full, dots and none (phase 4, one
    forward + backward with the train state resident), the bench_8b.py
    recipe (phase 6, whole steps). Each prediction must be within 15% of
    torch.cuda.max_memory_allocated, and each must fit the card, since
    each ran. Prints the working-set factor this run implies for each (the
    fit PERF.md keeps), the memory outside the caching allocator and the
    allocator's own slack, and the loop's flash_qkv peak (priced as
    "none", the reference's rule) for information."""
    from ray_tpu_torch.train import memory

    def implied(plan, cfg, measured, per_layer):
        unit = plan.batch * plan.seq * cfg.d_ff * cfg.dtype.itemsize
        boundary = cfg.n_layers * plan.batch * plan.seq * cfg.d_model \
            * cfg.dtype.itemsize
        fixed = plan.total_bytes - plan.activation_bytes + boundary
        return (measured - fixed) / (unit * (cfg.n_layers if per_layer
                                             else 1))

    cases = []
    for mode in ("full", "dots", "none"):
        cfg = dataclasses.replace(p4["cfg"], remat=mode)
        run = p4["modes"][mode]
        cases.append((f"bench remat {mode}", cfg,
                      memory.plan(cfg, batch, seq), run["peak"],
                      run["slack"], mode != "full"))
    cfg8 = memory.bench8b_config(p6["n_layers"])
    cases.append(("bench_8b recipe", cfg8,
                  memory.plan_bench8b(p6["n_layers"], p6["batch"],
                                      p6["seq"]), p6["peak"], p6["slack"],
                  False))
    out = {}
    for label, cfg, plan, measured, slack, per_layer in cases:
        err = plan.total_bytes / measured - 1
        factor = implied(plan, cfg, measured, per_layer)
        print(f"  planner {label}: predicted {plan.total_gb:.2f} GiB, "
              f"measured {measured / 2**30:.2f} GiB ({err:+.1%}); fits "
              f"{plan.fits} (usable {plan.usable_bytes / 2**30:.2f} GiB); "
              f"implied factor {factor:.3f}; allocator slack at the peak "
              f"{slack / 2**30:.3f} GiB")
        check(abs(err) <= 0.15 and plan.fits,
              f"planner {label}: {plan.total_gb:.2f} GiB against "
              f"{measured / 2**30:.2f} GiB measured, fits {plan.fits}")
        out[label] = dict(pred_gib=plan.total_gb, peak_gib=measured / 2**30,
                          err=err, factor=factor, slack=slack)
    loop = memory.plan(p7["cfg"], batch, seq)
    print(f"  planner training loop (remat flash_qkv, priced as none): "
          f"predicted {loop.total_gb:.2f} GiB, measured "
          f"{p7['peak'] / 2**30:.2f} GiB")
    free, total = torch.cuda.mem_get_info()
    outside = total - free - torch.cuda.memory_reserved()
    slack = max(v["slack"] for v in out.values())
    print(f"  card {total / 2**30:.2f} GiB: {outside / 2**30:.3f} GiB outside "
          f"the caching allocator (context, libraries) + largest allocator "
          f"slack at a priced peak {slack / 2**30:.3f} GiB = "
          f"{(outside + slack) / 2**30:.3f} GiB; reserve priced "
          f"{memory.ALLOCATOR_RESERVE_BYTES / 2**30:.3f} GiB")
    return out

# ------------------------------------------------------------ phase 8
# The local head layouts (query heads, KV heads, head_dim) a tp rank hands
# the kernels, with the (B, S) of the flash calls: the bench preset at
# tp = 2 (phase 4's batch), llama3_8b at tp = 8 (the bench_8b.py recipe's
# B=2 S=4096), moe_bench at tp = 2; P1 at llama3_8b tp = 2 and 8 and mini
# tp = 4 (phase 2's first decode step). Only the first flash layout and
# the first paged one run on phase 8b's main path (two ranks on one card).
TP_FLASH = (("bench tp=2", (4, 2, 128), (16, 2048), "_tp2"),
            ("llama3_8b tp=8", (4, 1, 128), (2, 4096), "_8b_tp8"),
            ("moe_bench tp=2", (8, 4, 64), (16, 2048), "_d64_tp2"))
TP_PAGED = (("llama3_8b tp=2", (16, 4, 128), "_tp2"),
            ("llama3_8b tp=8", (4, 1, 128), "_tp8"),
            ("mini tp=4", (3, 1, 64), "_mini_tp4"))
# Two ranks on one card over gloo: the losses and gradient norms of the
# sharded bench steps against the same steps in one process on the same
# weights and batch, both with no learning-rate warm-up, so that step 1's
# loss is taken after a full-rate AdamW update of the sharded state. They
# differ by bf16 rounding only: fsdp's ranks run products of half the rows
# (other cuBLAS tiles), tp's ranks sum bf16 partial products over the
# ranks where one product summed them in fp32. Sound runs read at most
# 1.8e-5 (loss) and 7.2e-4 (gradient norm), both at tp's step 1; a planted
# fault at least 3.8e-4 (loss: fsdp's gradient reduce-scatter left out, at
# step 1 only) and 0.26 or NaN (gradient norm; the tp sum of activations
# or of gradients left out) (sharded_chip.py train-faults; PERF.md PR 7).
TWO_RANK_LOSS_REL = 1e-4
TWO_RANK_NORM_REL = 2e-3
# The rows of phase 8a whose shapes phase 8b's main path runs (and whose
# launches it counts): the kernels line carries them.
TP_MAIN_ROWS = ("paged_attention_tp2", "flash_fwd_train_tp2",
                "flash_bwd_tp2")


def heads_cfg(heads, dtype=torch.bfloat16):
    """What the timing functions read of a config, at one head layout."""
    h, hkv, dh = heads
    return types.SimpleNamespace(n_heads=h, n_kv_heads=hkv, head_dim=dh,
                                 dtype=dtype)


def phase8a(positions):
    """F1/F2 and P1 at the local shapes of a tp rank, against their plain
    versions in fp32 on the same bf16 inputs (bf16, the main paths' type;
    ``FLASH_ORACLE_TOL``, ``PAGED_ORACLE_TOL``), then timed like the
    full-width rows."""
    print("phase 8a: the kernels at a tp rank's local shapes")
    rows = {}
    for label, heads, (b, s), tag in TP_FLASH:
        print(f"  {label}: heads {heads[0]}/{heads[1]} of {heads[2]}, "
              f"B={b} S={s}")
        errs = flash_bwd_checks({torch.bfloat16: FLASH_BF16_TOL},
                                heads=heads, shapes=((b, s),),
                                dtypes=(torch.bfloat16,), train=(b, s),
                                tag=tag, oracle=True)
        rows.update(timing_training(heads_cfg(heads), errs, batch=b, seq=s,
                                    tag=tag))
    for label, heads, tag in TP_PAGED:
        print(f"  {label}: heads {heads[0]}/{heads[1]} of {heads[2]}")
        err = paged_checks(heads=heads, oracle=True)
        rows["paged_attention" + tag] = paged_row(
            heads_cfg(heads), positions, err, "paged_attention" + tag)
    return rows


def rank_serve(seed, tp, inspect=None):
    """One rank of llama3_8b served with mesh {"tp": tp}: phase 2's
    prompts, paged, 32 greedy tokens. ``inspect(engine, prompts)``, when
    given, runs after them; its answer is the result's "inspect"."""
    from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import PRESETS, init_params
    from ray_tpu_torch.parallel.mesh import make_mesh

    cfg = PRESETS["llama3_8b"]
    mesh = make_mesh({"tp": tp})
    params = init_params(cfg, seed, device="cuda", dtype=cfg.dtype)
    eng = LLMEngine(cfg, max_batch=8, max_seq=2048, params=params, mesh=mesh,
                    kv="paged", page_size=64, seed=seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    prompts = serving_prompts(cfg, np.random.default_rng(seed))
    serve(eng, prompts, SamplingParams(max_tokens=2))  # warm-up
    steps0 = eng.stats()["decode_steps"]
    reset_counts()
    outs, step_s, step_tokens, _ = serve(eng, prompts,
                                         SamplingParams(max_tokens=32))
    launches = counts()[0]
    out = dict(outs=outs, launches=launches,
               decode_steps=eng.stats()["decode_steps"] - steps0,
               kv_heads=eng.cache["k"].shape[2],
               decode_tps=sum(step_tokens[1:]) / sum(step_s[1:]),
               peak=torch.cuda.max_memory_allocated())
    if inspect is not None:
        out["inspect"] = inspect(eng, prompts)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Depth of the two-rank training runs of phases 8b, 9 (not 9a's
# pipeline) and 12c: the bench preset at full width with 2 of its 24
# layers (6 before phase 17 came). Over gloo a step's time is its host
# copies, which grow with the depth; each run is held to one process at
# the same depth.
TWO_RANK_LAYERS = 2


def two_rank_bench():
    """The bench preset with flash attention at TWO_RANK_LAYERS layers."""
    from ray_tpu_torch.models.llama import PRESETS

    return dataclasses.replace(PRESETS["bench"], attn_impl="flash",
                               n_layers=TWO_RANK_LAYERS)


def rank_train(seed, sizes, batch=16, seq=2048, steps=2, cfg=None,
               keep_state=False, inspect=None):
    """One rank of the first ``steps`` train steps of ``cfg`` (by default
    :func:`two_rank_bench`) under mesh ``sizes`` (axis
    sizes for make_mesh, or a function that builds the mesh; None: one
    process, no mesh): phase 4's weights (from the seed) and batch (the
    whole batch; the step cuts it over the data axes), phase 4's
    optimizer with no warm-up (the first update at the full learning
    rate). ``keep_state`` returns the state too (phase 12c saves it);
    ``inspect(state, step, data)``, when given, runs after the steps and
    its answer is the result's "inspect"."""
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.train.step import (
        init_train_state,
        jit_train_step,
        make_optimizer,
    )

    if cfg is None:
        cfg = two_rank_bench()
    mesh = (sizes() if callable(sizes)
            else make_mesh(sizes) if sizes else None)
    opt = make_optimizer(warmup=0, total_steps=1000,
                         mu_dtype=torch.bfloat16)
    state = init_train_state(cfg, opt, seed=seed, device="cuda", mesh=mesh)
    step = jit_train_step(cfg, opt, mesh)
    rng = np.random.default_rng(seed)
    data = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq + 1))).to("cuda")}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, norms, aux, wall = [], [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, data)
        sync()
        wall.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if "aux_loss" in m:
            aux.append(float(m["aux_loss"]))
    _, f1, f2 = counts()
    out = dict(losses=losses, norms=norms, aux=aux, wall=wall, f1=f1, f2=f2,
               peak=torch.cuda.max_memory_allocated())
    if inspect is not None:
        out["inspect"] = inspect(state, step, data)
    if keep_state:
        out["state"] = state
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Meshes of phase 8b's training runs, two ranks each.
TWO_RANK_MESHES = {"fsdp=2": {"fsdp": 2}, "tp=2": {"tp": 2}}


def _serve_and_train(seed):
    """Phase 8b's work on one rank: llama3_8b served with mesh {"tp": 2},
    then the bench steps under each of ``TWO_RANK_MESHES``."""
    out = {"serve": rank_serve(seed, 2)}
    out.update({name: rank_train(seed, sizes)
                for name, sizes in TWO_RANK_MESHES.items()})
    return out


def _rank_main(rank, world, rdzv, results, work, args, backend):
    """A spawned rank. ``backend`` "nccl": rank r on cuda:r, a card of its
    own, NCCL carrying the collectives on the card; "gloo": every rank on
    cuda:0, shared, gloo carrying the collectives (copying CUDA tensors
    through host memory). Puts (rank, True, ``work(*args)``) or (rank,
    False, the traceback) on ``results``."""
    import torch.distributed as dist

    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
            dist.init_process_group("nccl", init_method=rdzv,
                                    world_size=world, rank=rank,
                                    device_id=torch.device("cuda", rank))
        else:
            dist.init_process_group("gloo", init_method=rdzv,
                                    world_size=world, rank=rank)
            torch.cuda.set_device(0)
        results.put((rank, True, work(*args)))
    except BaseException:  # the parent fails the phase with this text
        import traceback

        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(work, args, world=2, backend="gloo", timeout=600):
    """Spawn ``world`` ranks running ``work(*args)`` (a module-level
    function) on ``backend`` (:func:`_rank_main`; "nccl" needs ``world``
    cards), wait for every result (at most ``timeout`` seconds), kill
    whatever is left, raise on any failure. Returns the results in rank
    order."""
    import multiprocessing as mp
    import os
    import queue
    import tempfile

    if backend == "nccl" and torch.cuda.device_count() < world:
        raise SmokeFailure(f"{world} NCCL ranks need {world} cards; this "
                           f"machine has {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rdzv_") as tmp:
        rdzv = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, rdzv, results, work, args,
                                   backend))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        out = {}
        try:
            while len(out) < world:
                try:
                    rank, ok, payload = results.get(
                        timeout=max(deadline - time.monotonic(), 1.0))
                except queue.Empty:
                    raise SmokeFailure(f"{world - len(out)} of {world} ranks "
                                       f"gave no result in {timeout} s")
                check(ok, f"rank {rank} of {world} failed:\n{payload}")
                out[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 5.0))
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]


def phase8b(seed, p4, p2_outs):
    """Two ranks on the one card over gloo (correctness only: their times
    include host copies of every collective): llama3_8b at full width and
    depth served with mesh {"tp": 2}, then the first two steps of the
    bench preset at TWO_RANK_LAYERS layers under {"fsdp": 2} and
    {"tp": 2}."""
    from ray_tpu_torch.models.llama import PRESETS, init_params
    from ray_tpu_torch.train import memory

    print("phase 8b: two ranks on one card over gloo (correctness only)")
    single = rank_train(seed, None)
    print(f"  bench in one process, no warm-up: losses {single['losses']}, "
          f"grad_norms {single['norms']}")
    t0 = time.time()
    ranks = run_ranks(_serve_and_train, (seed,), world=2, backend="gloo")
    print(f"  two ranks ran in {time.time() - t0:.1f} s")
    cfg = PRESETS["llama3_8b"]
    sv = [r["serve"] for r in ranks]
    check(sv[0]["outs"] == sv[1]["outs"], "the tp ranks emitted different "
          "streams")
    check(all(len(o) == 32 for o in sv[0]["outs"]),
          "a tp request did not finish with 32 tokens")
    for r in sv:
        check(r["kv_heads"] == cfg.n_kv_heads // 2,
              f"a tp rank's pool holds {r['kv_heads']} KV heads")
        check(r["launches"] == cfg.n_layers * r["decode_steps"],
              f"a tp rank launched P1 {r['launches']} times for "
              f"{r['decode_steps']} decode steps x {cfg.n_layers} layers")
    print(f"  serving llama3_8b tp=2: {sv[0]['decode_steps']} decode steps, "
          f"P1 launches {sv[0]['launches']} + {sv[1]['launches']}, "
          f"{sv[0]['kv_heads']} KV heads per rank, decode "
          f"{sv[0]['decode_tps']:.1f} tokens/s (gloo), peak "
          f"{sv[0]['peak'] / 2**30:.2f} / {sv[1]['peak'] / 2**30:.2f} GiB "
          f"per rank")
    params = init_params(cfg, seed, device="cuda", dtype=cfg.dtype)
    prompts = serving_prompts(cfg, np.random.default_rng(seed))
    stream_check(cfg, params, prompts, sv[0]["outs"], "tp=2 greedy")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out = {"single": single["losses"], "single_norms": single["norms"],
           "serve_launches": sv[0]["launches"] + sv[1]["launches"],
           "same_streams": sum(a == b for a, b in zip(sv[0]["outs"],
                                                       p2_outs))}
    print(f"  tp=2 streams equal to phase 2's single-process streams: "
          f"{out['same_streams']} of {len(prompts)}")
    bench = two_rank_bench()
    for name in TWO_RANK_MESHES:
        tr = [r[name] for r in ranks]
        check(tr[0]["losses"] == tr[1]["losses"]
              and tr[0]["norms"] == tr[1]["norms"],
              f"{name}: the ranks report different losses")
        for i, (loss, norm) in enumerate(zip(tr[0]["losses"],
                                             tr[0]["norms"])):
            want, want_norm = single["losses"][i], single["norms"][i]
            rel, rel_norm = abs(loss / want - 1), abs(norm / want_norm - 1)
            print(f"  bench {name} step {i}: loss {loss:.6f} (single "
                  f"process {want:.6f}, rel {rel:.2e}), grad_norm "
                  f"{norm:.6f} ({want_norm:.6f}, rel {rel_norm:.2e}), "
                  f"{tr[0]['wall'][i]:.2f} s (gloo)")
            check(rel <= TWO_RANK_LOSS_REL and rel_norm <= TWO_RANK_NORM_REL,
                  f"{name} step {i}: loss or gradient norm off the single "
                  f"process's by more than {TWO_RANK_LOSS_REL} / "
                  f"{TWO_RANK_NORM_REL}")
        n = bench.n_layers * 2
        for r in tr:
            check(r["f1"] == n and r["f2"] == n,
                  f"{name}: a rank launched F1 {r['f1']} and F2 {r['f2']} "
                  f"times, expected {n} each")
        per_rank_batch = 16 // TWO_RANK_MESHES[name].get("fsdp", 1)
        plan = memory.plan(bench, per_rank_batch, 2048,
                           fsdp=TWO_RANK_MESHES[name].get("fsdp", 1))
        print(f"  bench {name}: F1 {tr[0]['f1']} + {tr[1]['f1']}, F2 "
              f"{tr[0]['f2']} + {tr[1]['f2']} launches; per-rank peak "
              f"{tr[0]['peak'] / 2**30:.2f} / {tr[1]['peak'] / 2**30:.2f} "
              f"GiB beside plan_memory(batch {per_rank_batch}, fsdp "
              f"{TWO_RANK_MESHES[name].get('fsdp', 1)}) "
              f"{plan.total_gb:.2f} GiB (remat flash_qkv priced as none)")
        out[name] = dict(f1=tr[0]["f1"] + tr[1]["f1"],
                         f2=tr[0]["f2"] + tr[1]["f2"],
                         peaks=[r["peak"] for r in tr], plan=plan.total_gb,
                         losses=tr[0]["losses"], norms=tr[0]["norms"])
    return out


# ------------------------------------------------------------ phase 9
# Pipeline parallelism (9a): the bench preset's 24 layers as 2 stages of
# 12 over pp = 2, GPipe with 4 microbatches of phase 4's 16 x 2048 batch.
PIPE_STAGES, PIPE_MICRO = 2, 4
# The flash kernels at the pipeline's microbatch shape (B = 16 / 4): the
# kernels line's rows "flash_fwd_train_pp" and "flash_bwd_pp".
PIPE_SHAPE = (16 // PIPE_MICRO, 2048)
# 9c, remat "flash_qkv_ffn8" under tp = 2, against one process under the
# same mode: the loss and gradient norm within phase 8b's limits (sound
# runs read loss 1.6e-5 to 2.5e-5, gradient norms at most 6.3e-4; PERF.md
# PR 8). Leaving the tp max of the int8 scale out moves neither beyond
# them (loss 2.7e-5, gradient norm 9.5e-4: each rank quantizes its columns
# more finely), so every int8 value and scale the step's kept op makes is
# held exactly to the whole rows' quantization, on every
# INT8_ROW_STRIDE-th row of each activation (256 of bench's 32768).
INT8_ROW_STRIDE = 128
# moe_bench (9d) against one process. Step 0 reads the same loss and aux
# bits; after one full-rate update, routing near-ties that the two runs'
# bf16 roundings (and F2's atomics) move flip: step 1 read loss 6.1e-5 to
# 9.1e-5 relative, aux 2.5e-3 to 2.7e-3, gradient norm up to 1.1e-3
# (three chip runs). Routing in per-rank groups where the groups span sp
# read loss 1.7e-4 / 1.5e-3, aux 6.9e-2 / 1.0e-1 and gradient norms
# 9.0e-3 / 3.0e-2 (steps 0 / 1; sharded_chip.py train-faults;
# PERF.md).
MOE_LOSS_REL = 1e-3
MOE_AUX_REL = 1e-2
MOE_NORM_REL = 5e-3


def _multislice_fsdp2():
    """9e's mesh: {"fsdp": 2} across two fake slices of one rank each."""
    from ray_tpu_torch.parallel.mesh import (
        fake_slice_devices,
        make_multislice_mesh,
    )

    return make_multislice_mesh({}, {"fsdp": 2},
                                ranks=fake_slice_devices(2))


def phase9_runs():
    """Phase 9's two-rank training runs: name -> (config, mesh sizes or a
    function that builds the mesh). 9b the bench preset with flash
    attention under sp = 2 (the sequence gathered for F1/F2); 9c the
    bench preset under remat
    "flash_qkv_ffn8" with tp = 2; 9d moe_bench (flash) under sp = 2 with
    routing groups of 2048 tokens, one whole sequence, so that every group
    spans both sp ranks (moe_bench's own 1024-token groups would lie in
    one rank's block, the path phase 5 runs); 9e phase 8b's fsdp = 2 run
    on a multislice mesh of two one-rank fake slices."""
    from ray_tpu_torch.models.moe import MOE_PRESETS

    bench = two_rank_bench()
    moe = dataclasses.replace(MOE_PRESETS["moe_bench"], attn_impl="flash",
                              group_size=2048)
    return {
        "sp=2": (bench, {"sp": 2}),
        "tp=2 ffn8": (dataclasses.replace(bench, remat="flash_qkv_ffn8"),
                      {"tp": 2}),
        "moe sp=2": (moe, {"sp": 2}),
        "multislice fsdp=2": (bench, _multislice_fsdp2),
    }


def _pipeline_config():
    """9a's model: the bench preset at full depth, flash, remat
    "flash_qkv"."""
    from ray_tpu_torch.models.llama import PRESETS

    return dataclasses.replace(PRESETS["bench"], attn_impl="flash")


def _pipeline_inputs(seed):
    """:func:`_pipeline_config`, its fp32 weights and phase 4's batch,
    from the seed."""
    from ray_tpu_torch.models.llama import init_params

    cfg = _pipeline_config()
    params = init_params(cfg, seed, device="cuda")
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (16, 2048 + 1))).to("cuda")
    return cfg, params, tokens


def _pipeline_pieces(cfg, params, tokens):
    """(embedded inputs, targets, stage_fn, loss_head) of 9a: the
    embedding before the pipeline, a stage's layers through the port's
    layer loop (flash attention, remat "flash_qkv"), the final norm and
    the chunked cross entropy as the replicated loss head."""
    from ray_tpu_torch.models.llama import apply_blocks, embed
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.norms import rms_norm
    from ray_tpu_torch.ops.rope import rope_frequencies
    from ray_tpu_torch.train.step import chunked_cross_entropy

    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    cos, sin = rope_frequencies(cfg.head_dim, inputs.shape[1],
                                cfg.rope_theta, device=tokens.device)

    def stage_fn(p, x):
        return apply_blocks(x, p, cos, sin, cfg, flash_attention)[0]

    def loss_head(y, batch):
        return chunked_cross_entropy(rms_norm(y, params["final_norm"]),
                                     params["lm_head"], batch["targets"],
                                     cfg.dtype)

    return embed(params, inputs, cfg), targets, stage_fn, loss_head


def pipeline_single(seed):
    """9a's reference: the same 24 blocks applied in order in one process
    on the whole batch; the loss and each parameter's gradient norm."""
    cfg, params, tokens = _pipeline_inputs(seed)
    leaves = _leaf_dict(params)
    for t in leaves.values():
        t.requires_grad_(True)
    reset_counts()
    t0 = time.perf_counter()
    x, targets, stage_fn, loss_head = _pipeline_pieces(cfg, params, tokens)
    loss = loss_head(stage_fn(params["blocks"], x), {"targets": targets})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    sync()
    wall = time.perf_counter() - t0
    _, f1, f2 = counts()
    norms = {k: float(g.float().norm()) for k, g in zip(leaves, grads)}
    out = dict(loss=loss.item(), norms=norms, f1=f1, f2=f2, wall=wall)
    del params, leaves, grads, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _leaf_dict(params):
    return {"tok_emb": params["tok_emb"], "final_norm": params["final_norm"],
            "lm_head": params["lm_head"],
            **{"blocks/" + k: v for k, v in params["blocks"].items()}}


def mesh_backends(mesh):
    """The process-group backend of each of ``mesh``'s axes of more than
    one rank."""
    import torch.distributed as dist

    return {axis: dist.get_backend(mesh.get_group(axis))
            for axis, size in zip(mesh.mesh_dim_names, mesh.shape)
            if size > 1}


def rank_pipeline(seed, stages=PIPE_STAGES, repeats=1):
    """One rank of 9a: ``pipeline_loss_fn`` over mesh {"pp": ``stages``}
    with 4 microbatches; the rank holds its stage's layers (DTensors
    placed over pp, stacked [stages, 24 / stages, ...]) and the embedding,
    final norm and lm_head whole. The loss and gradients run ``repeats``
    times on the same weights; returns the first run's loss and each
    parameter's gradient norm (a stage leaf's summed over pp), the flash
    launches of the first run, each run's wall time and the mesh's
    backends."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import make_mesh, mesh_spec, pipeline_loss_fn
    from ray_tpu_torch.parallel.sharding import distribute, local

    cfg, params, tokens = _pipeline_inputs(seed)
    mesh = make_mesh({"pp": stages})
    params["blocks"] = {
        k: distribute(v.reshape(stages, -1, *v.shape[1:]), mesh,
                      mesh_spec("pp"))
        for k, v in params["blocks"].items()}
    gc.collect()
    torch.cuda.empty_cache()
    leaves = _leaf_dict(params)
    for t in leaves.values():
        t.requires_grad_(True)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(repeats):
        reset_counts()
        t0 = time.perf_counter()
        x, targets, stage_fn, loss_head = _pipeline_pieces(cfg, params,
                                                           tokens)
        loss = pipeline_loss_fn(params["blocks"],
                                {"inputs": x, "targets": targets}, stage_fn,
                                loss_head, mesh=mesh,
                                num_microbatches=PIPE_MICRO)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        sync()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            _, f1, f2 = counts()
            first_loss, first_grads = loss, grads
    loss, grads, wall = first_loss, first_grads, walls[0]
    norms = {}
    for k, g in zip(leaves, grads):
        sq = local(g).float().square().sum()
        if k.startswith("blocks/"):
            dist.all_reduce(sq, group=mesh.get_group("pp"))
        norms[k] = float(sq.sqrt())
    out = dict(loss=loss.item(), norms=norms, f1=f1, f2=f2, wall=wall,
               walls=walls, peak=torch.cuda.max_memory_allocated(),
               backends=mesh_backends(mesh))
    del params, leaves, grads, loss, first_loss, first_grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def int8_recorded():
    """Within: every quantization the int8 op of "flash_qkv_ffn8" makes
    (models/llama.py's ``_int8_ckpt_op``, through ``quantize_int8``)
    appends to the yielded list this rank's columns of every
    ``INT8_ROW_STRIDE``-th row of its activation, with their int8 values
    and scales as the op returned them."""
    from ray_tpu_torch.models import llama

    real, calls = llama.quantize_int8, []

    def record(x, mesh=None):
        q, scale = real(x, mesh)
        calls.append(tuple(t.reshape(-1, t.shape[-1])[::INT8_ROW_STRIDE]
                           .clone(memory_format=torch.contiguous_format)
                           for t in (x, q, scale)))
        return q, scale

    llama.quantize_int8 = record
    try:
        yield calls
    finally:
        llama.quantize_int8 = real


def int8_mismatches(calls):
    """How many recorded int8 values and scales differ from the whole
    rows' quantization: each recorded block gathered over the two ranks
    (mesh {"tp": 2}: rank r holds columns block r), quantized with no
    mesh, this rank's columns kept."""
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import quantize_int8

    rank, bad = dist.get_rank(), 0
    for x, q, scale in calls:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        want_q, want_scale = quantize_int8(torch.cat(parts, -1))
        bad += int((want_q.chunk(len(parts), -1)[rank] != q).sum()
                   + (want_scale != scale).sum())
    return bad


def rank_phase9(seed, name):
    """One rank of one phase 9 run: "pipeline" (9a) or a name of
    :func:`phase9_runs`; under "tp=2 ffn8" with the int8 op's
    quantizations of both steps held to the whole rows'
    (:func:`int8_mismatches`)."""
    if name == "pipeline":
        return rank_pipeline(seed)
    cfg, sizes = phase9_runs()[name]
    if name != "tp=2 ffn8":
        return rank_train(seed, sizes, cfg=cfg)
    with int8_recorded() as calls:
        out = rank_train(seed, sizes, cfg=cfg)
    out["int8"] = dict(calls=len(calls), bad=int8_mismatches(calls),
                       values=sum(q.numel() + s.numel() for _, q, s in calls))
    return out


def phase9_single(seed, name):
    """The one-process run a phase 9 run is held to."""
    if name == "pipeline":
        return pipeline_single(seed)
    cfg, _ = phase9_runs()[name]
    return rank_train(seed, None, cfg=cfg)


PHASE9_NAMES = ("pipeline", "sp=2", "tp=2 ffn8", "moe sp=2",
                "multislice fsdp=2")


def _phase9_work(seed):
    return {name: rank_phase9(seed, name) for name in PHASE9_NAMES}


def _rel(got, want):
    """|got / want - 1|, infinite for a NaN or an infinity."""
    return abs(got / want - 1) if math.isfinite(got) else math.inf


def phase9_readings(name, rank, single):
    """(text, ok): one rank's phase 9 run against its one-process run, at
    phase 9's limits. The pipeline: the loss within TWO_RANK_LOSS_REL and
    each parameter's gradient norm within TWO_RANK_NORM_REL; a training
    run: each step's loss (and MoE aux loss) within TWO_RANK_LOSS_REL
    (MOE_LOSS_REL for MoE, its aux loss within MOE_AUX_REL), each gradient
    norm within TWO_RANK_NORM_REL (MOE_NORM_REL for MoE); under
    "flash_qkv_ffn8" also the int8 op's quantizations: two per layer and
    step, no recorded value differing from the whole rows'."""
    if name == "pipeline":
        loss = _rel(rank["loss"], single["loss"])
        norms = {k: _rel(v, single["norms"][k])
                 for k, v in rank["norms"].items()}
        worst = max(norms, key=norms.get)
        return (f"loss {rank['loss']:.6f} (one process {single['loss']:.6f}"
                f", rel {loss:.2e}, limit {TWO_RANK_LOSS_REL}); gradient "
                f"norms rel at most {norms[worst]:.2e} ({worst}, limit "
                f"{TWO_RANK_NORM_REL})",
                loss <= TWO_RANK_LOSS_REL
                and norms[worst] <= TWO_RANK_NORM_REL)
    loss_limit = MOE_LOSS_REL if name == "moe sp=2" else TWO_RANK_LOSS_REL
    norm_limit = MOE_NORM_REL if name == "moe sp=2" else TWO_RANK_NORM_REL
    loss = [_rel(a, b) for a, b in zip(rank["losses"], single["losses"])]
    aux = [_rel(a, b) for a, b in zip(rank["aux"], single["aux"])]
    norm = [_rel(a, b) for a, b in zip(rank["norms"], single["norms"])]
    text = (f"losses {rank['losses']} (one process {single['losses']}, rel "
            + ", ".join(f"{x:.2e}" for x in loss) + f", limit {loss_limit})"
            + (f"; aux {rank['aux']} (rel "
               + ", ".join(f"{x:.2e}" for x in aux)
               + f", limit {MOE_AUX_REL})" if aux else "")
            + "; grad_norms rel " + ", ".join(f"{x:.2e}" for x in norm)
            + f" (limit {norm_limit})")
    ok = (max(loss) <= loss_limit and max(aux, default=0.0) <= MOE_AUX_REL
          and max(norm) <= norm_limit)
    if "int8" in rank:
        q8 = rank["int8"]
        want = 2 * phase9_runs()[name][0].n_layers * len(rank["losses"])
        text += (f"; int8 op: {q8['calls']} quantizations (expected "
                 f"{want}), {q8['bad']} of {q8['values']} recorded values "
                 f"and scales differ from the whole rows' (limit 0)")
        ok = ok and q8["calls"] == want and q8["bad"] == 0
    return text, ok


def phase9(seed, p8):
    """Two ranks on the one card over gloo (correctness only): (a) the
    bench preset pipelined over pp = 2, (b) under sp = 2 with flash, (c)
    under tp = 2 with remat "flash_qkv_ffn8", its int8 op held exact,
    (d) moe_bench under sp = 2 with groups spanning the ranks, (e) phase
    8b's fsdp = 2 run on a multislice mesh; each against one process."""
    print("phase 9: pipeline, sequence-gathered attention, int8 under tp, "
          "MoE under sp, multislice (two ranks over gloo, correctness "
          "only)")
    b, s = PIPE_SHAPE
    print(f"  the flash kernels at the pipeline's microbatch shape: B={b} "
          f"S={s}, heads {BENCH_HEADS[0]}/{BENCH_HEADS[1]} of "
          f"{BENCH_HEADS[2]}")
    errs = flash_bwd_checks({torch.bfloat16: FLASH_BF16_TOL},
                            heads=BENCH_HEADS, shapes=(PIPE_SHAPE,),
                            dtypes=(torch.bfloat16,), train=PIPE_SHAPE,
                            tag="_pp", oracle=True)
    rows = timing_training(heads_cfg(BENCH_HEADS), errs, batch=b, seq=s,
                           tag="_pp")
    single = {"sp=2": dict(losses=p8["single"], norms=p8["single_norms"],
                           aux=[])}
    for name in ("pipeline", "tp=2 ffn8", "moe sp=2"):
        t0 = time.time()
        single[name] = phase9_single(seed, name)
        print(f"  {name} in one process ({time.time() - t0:.1f} s): "
              + (f"loss {single[name]['loss']:.6f}, flash launches "
                 f"{single[name]['f1']} + {single[name]['f2']}"
                 if name == "pipeline" else
                 f"losses {single[name]['losses']}, grad_norms "
                 f"{single[name]['norms']}"))
    t0 = time.time()
    ranks = run_ranks(_phase9_work, (seed,), world=2, backend="gloo")
    runs = phase9_runs()
    print(f"  two ranks ran in {time.time() - t0:.1f} s")
    out = {}
    pipe = [r["pipeline"] for r in ranks]
    n_steps = PIPE_MICRO + PIPE_STAGES - 1
    per_stage = _pipeline_config().n_layers // PIPE_STAGES
    for i, r in enumerate(pipe):
        text, ok = phase9_readings("pipeline", r, single["pipeline"])
        print(f"  9a pipeline pp=2 M={PIPE_MICRO}, rank {i}: {text}; flash "
              f"launches {r['f1']} + {r['f2']}, {r['wall']:.2f} s (gloo), "
              f"peak {r['peak'] / 2**30:.2f} GiB")
        check(ok, f"9a: rank {i}'s pipelined loss or a gradient norm is off "
                  f"the one-process run's")
        # remat "flash_qkv" keeps the flash outputs: no forward replay.
        want = n_steps * per_stage
        check(r["f1"] == want and r["f2"] == want,
              f"9a: rank {i} launched F1 {r['f1']} and F2 {r['f2']} times, "
              f"expected (M + P - 1) x {per_stage} = {want} each")
    out["pipeline"] = dict(f1=sum(r["f1"] for r in pipe),
                           f2=sum(r["f2"] for r in pipe),
                           loss=pipe[0]["loss"], rows=rows)
    for name, (cfg, _) in runs.items():
        tr = [r[name] for r in ranks]
        check(tr[0]["losses"] == tr[1]["losses"]
              and tr[0]["norms"] == tr[1]["norms"],
              f"{name}: the ranks report different losses")
        want_single = (single[name] if name in single
                       else dict(losses=p8["fsdp=2"]["losses"],
                                 norms=p8["fsdp=2"]["norms"], aux=[]))
        if name == "multislice fsdp=2":
            # The same program on the same layout as phase 8b's flat
            # fsdp = 2: step 0 bit for bit; step 1 follows an update whose
            # dq F2 sums with atomics (not bit-reproducible run to run).
            check(tr[0]["losses"][0] == p8["fsdp=2"]["losses"][0],
                  f"9e: step 0 loss {tr[0]['losses'][0]!r} is not phase "
                  f"8b's flat fsdp=2 {p8['fsdp=2']['losses'][0]!r}")
        readings = [phase9_readings(name, r, want_single) for r in tr]
        print(f"  9{'bcde'[list(runs).index(name)]} {name}: "
              f"{readings[0][0]}; {tr[0]['wall'][0]:.2f} + "
              f"{tr[0]['wall'][1]:.2f} s (gloo), flash launches "
              f"{tr[0]['f1']} + {tr[0]['f2']} per rank")
        bad = [f"rank {i}: {text}" for i, (text, ok) in enumerate(readings)
               if not ok]
        check(not bad, f"{name}: off the one-process run's: {bad}")
        per_step = (F1_PER_LAYER[cfg.remat] * cfg.n_layers, cfg.n_layers)
        check(all(r["f1"] == 2 * per_step[0] and r["f2"] == 2 * per_step[1]
                  for r in tr),
              f"{name}: a rank launched F1 {tr[0]['f1']} / {tr[1]['f1']} and "
              f"F2 {tr[0]['f2']} / {tr[1]['f2']} times in two steps, "
              f"expected {2 * per_step[0]} and {2 * per_step[1]}")
        out[name] = dict(f1=tr[0]["f1"] + tr[1]["f1"],
                         f2=tr[0]["f2"] + tr[1]["f2"],
                         losses=tr[0]["losses"])
    return out


# ------------------------------------------------------------ timing
# ------------------------------------------------------------ runtime
def numpy_tree(params):
    """A parameter tree as fp32 numpy arrays (bf16 widens exactly) and
    each leaf's torch dtype, for the object store."""
    if isinstance(params, dict):
        pairs = {k: numpy_tree(v) for k, v in params.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: d for k, (_, d) in pairs.items()})
    return (params.detach().float().cpu().numpy(),
            str(params.dtype).removeprefix("torch."))


def torch_tree(arrays, dtypes, device):
    """The inverse of :func:`numpy_tree`, on ``device``."""
    if isinstance(arrays, dict):
        return {k: torch_tree(arrays[k], dtypes[k], device) for k in arrays}
    return torch.from_numpy(np.asarray(arrays)).to(
        device=device, dtype=getattr(torch, dtypes))


def detection_without_cuda():
    """Run the node's resource detection in a fresh process: its GPU
    count, and whether it imported torch or created a CUDA context."""
    code = (
        "import json, sys\n"
        "from ray_tpu_torch.runtime.node import detect_resources\n"
        "res = detect_resources()\n"
        "loaded = 'torch' in sys.modules\n"
        "import torch\n"
        "print(json.dumps({'gpu': res.get('GPU'), 'torch_loaded': loaded,"
        " 'cuda_initialized': torch.cuda.is_initialized()}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


PHASE10_SHAPE = (1, 1024, 32, 8, 128)  # phase 3's prefill: B, S, H, Hkv, D


def lease_view():
    """What a leased worker sees of the cards: its
    ``CUDA_VISIBLE_DEVICES`` and ``CUDA_DEVICE_ORDER``."""
    import os

    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            os.environ.get("CUDA_DEVICE_ORDER"))


def flash_task(seed):
    """Phase 10's GPU task: F1 at phase 3's prefill shape on inputs drawn
    from ``seed`` in this worker; returns (pid, O, LSE, launches, the
    lease's view of the cards and how many CUDA shows)."""
    import os

    from ray_tpu_torch.ops.flash_attention import flash_attention_forward

    b, s, h, hkv, d = PHASE10_SHAPE
    q, k, v, _ = flash_inputs(b, s, torch.bfloat16, seed, h=h, hkv=hkv, d=d)
    flash_attention_forward.launches = 0
    o, lse = flash_attention_forward(q, k, v, True)
    sync()
    return (os.getpid(), o, lse, flash_attention_forward.launches,
            lease_view(), torch.cuda.device_count())


class LeaseView:
    """Phase 10's half-GPU actor: what its lease shows it."""

    def view(self):
        import os

        return lease_view(), os.getpid()


def gpu_probe():
    import os

    return os.getpid()


class MiniServer:
    """Phase 10's GPU actor: mini's paged LLMEngine on the card, built
    from the numpy tree that arrives through the object store."""

    def __init__(self, tree, seed):
        from ray_tpu_torch.llm.engine import LLMEngine
        from ray_tpu_torch.models.llama import PRESETS

        arrays, dtypes = tree
        self.cfg = PRESETS["mini"]
        params = torch_tree(arrays, dtypes, "cuda")
        self.engine = LLMEngine(self.cfg, max_batch=8, max_seq=2048,
                                params=params, kv="paged", page_size=64,
                                seed=seed, device="cuda")
        self.dense = LLMEngine(self.cfg, max_batch=1, max_seq=2048,
                               params=params, kv="dense", seed=seed,
                               device="cuda")
        sync()

    def ready(self):
        import os

        return os.getpid()

    def serve_greedy(self, prompts, max_tokens):
        """Phase 2's greedy pass: a 2-token warm-up, then the counted
        pass; returns (streams, (P1, F1) launches, decode tokens/s)."""
        from ray_tpu_torch.llm.engine import SamplingParams

        serve(self.engine, prompts, SamplingParams(max_tokens=2))
        reset_counts()
        outs, step_s, step_tokens, _ = serve(
            self.engine, prompts, SamplingParams(max_tokens=max_tokens))
        p_launch, f_launch, _ = counts()
        return (outs, (p_launch, f_launch),
                sum(step_tokens[1:]) / sum(step_s[1:]))

    def serve_dense(self, prompt, max_tokens):
        """Phase 3's dense prefill and decode of one prompt; returns (the
        stream, (P1, F1) launches)."""
        from ray_tpu_torch.llm.engine import SamplingParams

        reset_counts()
        outs, _s, _t, _f = serve(self.dense, [prompt],
                                 SamplingParams(max_tokens=max_tokens))
        p_launch, f_launch, _ = counts()
        return outs[0], (p_launch, f_launch)

    def memory(self):
        """One memory sample, read beside the allocator and the pool."""
        from ray_tpu_torch.runtime import memory

        rec = memory.sample()
        allocated = torch.cuda.memory_allocated()
        reg = memory._registry.get("llm.paged_kv")
        pool = self.engine.cache
        return {"sample": rec, "allocated": allocated,
                "claim": None if reg is None else reg.current_bytes(),
                "pool_bytes": pool["k"].nbytes + pool["v"].nbytes}


def phase10(seed, cfg, mini_tree, m2, m3, timeout=600):
    import ray_tpu_torch as rt
    import ray_tpu_torch.api as rt_api
    from ray_tpu_torch.ops.flash_attention import flash_attention_reference

    print("phase 10: the runtime on the card, a GPU task and a GPU actor")
    det = detection_without_cuda()
    print(f"  detection in a fresh process: {det}")
    check(det["gpu"] == float(torch.cuda.device_count()) == 1.0,
          f"the node detected {det['gpu']} GPUs, the card is one")
    check(not det["torch_loaded"] and not det["cuda_initialized"],
          "resource detection loaded torch or created a CUDA context")
    t0 = time.perf_counter()
    rt.init(num_cpus=4)
    init_s = time.perf_counter() - t0
    try:
        res = rt.cluster_resources()
        print(f"  cluster resources {res}")
        check(res.get("GPU") == 1.0, f"cluster GPU resource {res.get('GPU')}")

        # (b) a GPU task runs F1 in its own worker, bound to the card.
        b, s, h, hkv, d = PHASE10_SHAPE
        t0 = time.perf_counter()
        pid, o, lse, task_f1, view, n_cuda = rt.get(
            rt.remote(num_gpus=1)(flash_task).remote(seed), timeout=timeout)
        task_s = time.perf_counter() - t0
        check(pid != os.getpid(), "the GPU task ran in the driver")
        cards = list(rt_api._runtime.node.gpu_free)
        print(f"  the node's card {cards}; the GPU task's lease: "
              f"CUDA_VISIBLE_DEVICES {view[0]!r}, CUDA_DEVICE_ORDER "
              f"{view[1]!r}, {n_cuda} CUDA device(s)")
        check(len(cards) == 1 and view == (cards[0], "PCI_BUS_ID")
              and n_cuda == 1, "the GPU task's lease is not bound to the "
              "node's one card")
        check(o.is_cuda and o.dtype == torch.bfloat16
              and o.shape == (b, s, h, d) and lse.shape == (b * h, 1, s),
              f"GPU task returned O {o.dtype} {tuple(o.shape)} on {o.device}")
        check(task_f1 == 1, f"the GPU task launched F1 {task_f1} times")
        q, k, v, _ = flash_inputs(b, s, torch.bfloat16, seed, h=h, hkv=hkv,
                                  d=d)
        o_32, _ = flash_attention_reference(q.float(), k.float(), v.float(),
                                            True)
        _, lse_ref = flash_attention_reference(q, k, v, True)
        (atol, rtol), norm = FLASH_ORACLE_TOL, FLASH_ORACLE_NORM
        compare("GPU task F1 O vs fp32", o, o_32, atol, rtol, norm)
        compare("GPU task F1 LSE", lse, lse_ref, 1e-4, 1e-4)
        del q, k, v, o, lse, o_32, lse_ref

        # (c) a GPU actor serves mini from one put of its numpy tree.
        put_bytes = sum(a.nbytes for a in _leaves(mini_tree[0]))
        t0 = time.perf_counter()
        ref = rt.put(mini_tree)
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        actor = rt.remote(num_gpus=1)(MiniServer).remote(ref, seed)
        actor_pid = rt.get(actor.ready.remote(), timeout=timeout)
        cold_s = time.perf_counter() - t0
        check(actor_pid != os.getpid(), "the GPU actor runs in the driver")
        outs, launches, tps = rt.get(
            actor.serve_greedy.remote(m2["prompts"], len(m2["outs"][0])),
            timeout=timeout)
        same = sum(a == b for a, b in zip(outs, m2["outs"]))
        print(f"  actor (pid {actor_pid}): {same} of {len(outs)} streams "
              f"equal phase 2's; launches P1 {launches[0]} F1 {launches[1]} "
              f"(phase 2: {m2['greedy_launches']}); put of "
              f"{put_bytes / 1e9:.3f} GB took {put_s:.3f} s")
        check(same == len(outs) == len(m2["outs"]),
              "the actor's mini streams differ from phase 2's")
        check(tuple(launches) == tuple(m2["greedy_launches"]),
              f"the actor's P1/F1 launches {launches} are not phase 2's "
              f"{m2['greedy_launches']}")
        # The paged engine prefills without F1 (phase 2 counts none); the
        # actor's dense engine prefills through it, as phase 3's does.
        dense_out, dense_launches = rt.get(
            actor.serve_dense.remote(m3["prompt"], len(m3["out"])),
            timeout=timeout)
        print(f"  actor dense prefill + decode: stream equal to phase 3's: "
              f"{dense_out == m3['out']}; launches P1 {dense_launches[0]} "
              f"F1 {dense_launches[1]} (phase 3: F1 {m3['launches']})")
        check(dense_out == m3["out"],
              "the actor's dense mini stream differs from phase 3's")
        check(dense_launches == (0, m3["launches"]),
              f"the actor's dense launches {dense_launches} are not phase "
              f"3's (0, {m3['launches']})")

        # (e) the memory plane inside the actor, and the head's ledger.
        mem = rt.get(actor.memory.remote(), timeout=timeout)
        hbm = mem["sample"]["hbm"]
        print(f"  actor memory sample: used {hbm['used_bytes']} B "
              f"(memory_allocated {mem['allocated']}), source "
              f"{hbm['source']}, capacity {hbm['capacity_bytes']} "
              f"({hbm['capacity_source']}); llm.paged_kv claim "
              f"{mem['claim']} B, pool {mem['pool_bytes']} B")
        check(hbm["source"] == "memory_stats",
              f"the actor's sample came from {hbm['source']}")
        check(abs(hbm["used_bytes"] - mem["allocated"])
              <= 0.01 * mem["allocated"],
              "sampled device bytes are not within 1% of memory_allocated")
        check(mem["claim"] == mem["pool_bytes"],
              "the llm.paged_kv claim is not the pool's bytes")
        rtm = rt_api._runtime
        node = mem["sample"]["node"]
        deadline = time.monotonic() + 30
        while True:
            ledger = rtm.run(rtm.core.head.call("mem_stats"))
            row = ledger["nodes"].get(node)
            if row and row["used_bytes"] == hbm["used_bytes"]:
                break
            check(time.monotonic() < deadline,
                  f"the head's memory ledger does not show the sample: "
                  f"{row}")
            time.sleep(0.5)
        print(f"  head memory ledger, node {node}: used {row['used_bytes']} "
              f"B, by kind {row['by_kind']}, {row['samples']} samples")
        check(row["by_kind"].get("kv_cache") == mem["claim"],
              "the head's ledger does not carry the kv_cache claim")

        # (d) the actor holds the GPU: a second GPU task waits for it.
        waiting = rt.remote(num_gpus=1)(gpu_probe).remote()
        ready, _ = rt.wait([waiting], timeout=2.0)
        check(not ready, "a second num_gpus=1 task ran while the actor held "
              "the GPU")
        rt.kill(actor)
        t0 = time.perf_counter()
        probe_pid = rt.get(waiting, timeout=timeout)
        print(f"  second GPU task: waited 2 s while the actor held the GPU, "
              f"ran (pid {probe_pid}) {time.perf_counter() - t0:.3f} s after "
              f"the kill")
        # (f) two half-GPU actors share the one card.
        t0 = time.perf_counter()
        halves = [rt.remote(num_gpus=0.5)(LeaseView).remote()
                  for _ in range(2)]
        views = rt.get([h.view.remote() for h in halves], timeout=timeout)
        print(f"  two num_gpus=0.5 actors: {views}, "
              f"{time.perf_counter() - t0:.3f} s")
        check(all(v == (cards[0], "PCI_BUS_ID") for v, _ in views)
              and views[0][1] != views[1][1],
              "two half-GPU actors do not share the node's one card")
        for h in halves:
            rt.kill(h)
    finally:
        rt.shutdown()
    return {"init_s": init_s, "task_s": task_s, "cold_s": cold_s,
            "put_bytes": put_bytes, "decode_tokens_per_s": tps,
            "task_f1": task_f1,
            "actor_launches": (launches[0] + dense_launches[0],
                               launches[1] + dense_launches[1])}


# ------------------------------------------------------------- phase 11
P11_RANKS = 4  # mesh ranks sharing cuda:0
# (verb, shape, kwargs) of phase 11a, each run on 4 ranks of cuda:0 and on
# 4 CPU ranks, fp32 and bf16, random and integer-valued data.
MESH_CASES = (
    ("allreduce", (4096, 33), {}),
    ("allreduce", (4096, 33), {"op": "max"}),
    ("allreduce", (4096, 33), {"op": "min"}),
    ("allreduce", (64,), {"op": "product"}),
    ("allreduce", (4096, 33), {"algo": "ring"}),
    ("allreduce", (4096, 33), {"algo": "tree"}),
    ("allreduce", (512, 256), {"compression": "int8"}),
    ("allreduce", (4096, 33), {"min_ranks": 3, "skip_ranks": [2]}),
    ("allreduce", (512, 256), {"compression": "int8", "min_ranks": 3,
                               "skip_ranks": [1]}),
    ("reduce", (1000,), {}),
    ("allgather", (256, 33), {}),
    ("allgather", (3000,), {"compression": "int8"}),
    ("reducescatter", (4096, 33), {}),
    ("reducescatter", (4096, 33), {"algo": "tree"}),
    ("reducescatter", (4096, 33), {"op": "max"}),
    ("reducescatter", (4096, 33), {"compression": "int8"}),
    ("reducescatter", (4096, 33), {"min_ranks": 3, "skip_ranks": [0]}),
    ("broadcast", (1000,), {"root": 2}),
    ("permute", (1000,), {"perm": [(0, 1), (1, 2), (2, 3), (3, 0)]}),
)
TRANSPORT_BYTES = 256 << 20  # phase 11d's tensor


def _p11_inputs(seed, shape, ints, dtype, n=P11_RANKS):
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randint(-8, 9, shape, generator=g).float() if ints
          else torch.randn(shape, generator=g) for _ in range(n)]
    return [x.to(dtype) for x in xs]


def _p11_value(out):
    """(skipped or None, per-rank tensors) of a verb's result."""
    from ray_tpu_torch.collective.types import PartialResult

    if isinstance(out, PartialResult):
        return out.skipped, list(out.value)
    return None, list(out)


def mesh_verbs(seed, devices=("cuda:0",) * P11_RANKS, route="local",
               bf16_steps=1):
    """Phase 11a: every verb and mode of NcclMeshGroup with 4 ranks on
    cuda:0 (``devices``: its ranks; ``route``: the route they must take),
    against the same verb on as many CPU ranks on the same inputs.
    Integer-valued data exactly; random data at rtol 1e-5 in fp32 (the JAX
    tests' tolerance) and ``bf16_steps`` bf16 steps in bf16; the int8
    paths within one quantization step of the reduced value. Returns the
    group and the worst readings."""
    from ray_tpu_torch.collective.backends.nccl_group import NcclMeshGroup
    from ray_tpu_torch.collective.types import ReduceOp

    n = len(devices)
    card = NcclMeshGroup(list(devices), name="p11_card")
    host = NcclMeshGroup(["cpu"] * n, name="p11_host")
    check(card.route == route, f"{n} ranks on {devices} took {card.route}")
    worst = {"exact_cases": 0, "max_diff_fp32": 0.0, "max_diff_bf16": 0.0,
             "max_diff_int8": 0.0}
    runs = 0
    for i, (verb, shape, kw) in enumerate(MESH_CASES):
        kw = {k: ReduceOp(v) if k == "op" else v for k, v in kw.items()}
        for dtype in (torch.float32, torch.bfloat16):
            for ints in (False, True):
                if ints and "compression" in kw:
                    continue
                xs = _p11_inputs(seed + 100 * i, shape, ints, dtype, n)
                got = getattr(card, verb)(
                    [x.to(card._devs[r]) for r, x in enumerate(xs)], **kw)
                want = getattr(host, verb)(xs, **kw)
                sync()
                g_skip, g_vals = _p11_value(got)
                w_skip, w_vals = _p11_value(want)
                label = f"mesh {verb} {kw} {str(dtype)[6:]} ints={ints}"
                check(g_skip == w_skip, f"{label}: skipped {g_skip} vs "
                      f"{w_skip}")
                check(len(g_vals) == n
                      and all(v.device == d
                              for v, d in zip(g_vals, card._devs)),
                      f"{label}: results not on their ranks' devices")
                for g_v, w_v in zip(g_vals, w_vals):
                    g_v, w_v = g_v.float().cpu(), w_v.float()
                    check(g_v.shape == w_v.shape, f"{label}: shape "
                          f"{tuple(g_v.shape)} vs {tuple(w_v.shape)}")
                    diff = float((g_v - w_v).abs().max()) if g_v.numel() \
                        else 0.0
                    scale = float(w_v.abs().max()) if w_v.numel() else 0.0
                    if ints:
                        check(diff == 0.0, f"{label}: differs by {diff}")
                        continue
                    if "compression" in kw:
                        key, lim = "max_diff_int8", 2 * scale / 127
                    elif dtype == torch.float32:
                        key, lim = "max_diff_fp32", 1e-5 * (1 + scale)
                    else:
                        key, lim = "max_diff_bf16", bf16_steps * 2**-7 * scale
                    check(diff <= lim, f"{label}: differs by {diff:.3e} "
                          f"beyond {lim:.3e}")
                    worst[key] = max(worst[key], diff)
                worst["exact_cases"] += ints
                runs += 1
    # The async verbs: the same values as the sync ones.
    xs = [x.to(card._devs[r]) for r, x in enumerate(
        _p11_inputs(seed, (4096, 33), False, torch.float32, n))]
    for verb in ("allreduce", "allgather", "reducescatter"):
        work = getattr(card, f"{verb}_async")(xs)
        got = work.wait()
        want = getattr(card, verb)(xs)
        check(work.done() and all(torch.equal(a, b)
                                  for a, b in zip(got, want)),
              f"mesh {verb}_async differs from {verb}")
    card.barrier()
    try:
        card.send(xs[0], 1)
    except NotImplementedError:
        pass
    else:
        raise SmokeFailure("the mesh group took a send")
    worst["cases"] = runs
    print(f"  11a: {runs} verb runs on {n} ranks of "
          f"{', '.join(sorted(set(devices)))} (route "
          f"{card.route}) equal the CPU ranks' (integer data exactly in "
          f"{worst['exact_cases']}); worst random-data differences fp32 "
          f"{worst['max_diff_fp32']:.3e}, bf16 {worst['max_diff_bf16']:.3e},"
          f" int8 {worst['max_diff_int8']:.3e}; async verbs equal the sync "
          f"ones")
    return card, worst


def _tree_leaves_named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _tree_leaves_named(tree[k], f"{prefix}['{k}']")]
    return [(prefix, tree)]


def bucket_sync(card, seed):
    """Phase 11b: the bench preset's whole gradient tree (fp32, leaves
    named as in init_params) on each rank of ``card`` (4 ranks of cuda:0
    here), synced through GradBucketer: the synced mean equals the mean
    computed in one place, cold and warm times beside the bound (on one
    card every rank's tree read once and written once over the HBM rate;
    across cards the ring's bytes over NVLink); then again with int8
    compression, each leaf within the codec's bound (every rank's payload
    absmax / 254 plus the reduced payload's absmax / 254, per bucket)."""
    from ray_tpu_torch.collective.bucketer import GradBucketer
    from ray_tpu_torch.models.llama import PRESETS, init_params

    cfg = PRESETS["bench"]
    like = init_params(cfg, seed, device="cuda", dtype=torch.float32)
    named = _tree_leaves_named(like)
    gen = torch.Generator(device="cuda")
    n = card.world
    trees = []
    for r in range(n):
        gen.manual_seed(seed * 1000 + r)
        trees.append(_map_tree(like, lambda a: torch.randn(
            a.shape, generator=gen, device="cuda").to(card._devs[r])))
    del like
    per_rank = sum(a.numel() for _n, a in named) * 4
    if card.route == "local":  # every rank's tree in one card's memory
        bound_ms = 2 * n * per_rank / HBM_BYTES_PER_S * 1e3
    else:  # a ring over NVLink, one way per card, or the card's memory
        bound_ms = max(2 * per_rank / HBM_BYTES_PER_S,
                       2 * (n - 1) / n * per_rank / NVLINK_BYTES_PER_S) * 1e3
    out = {"leaves": len(named), "params": per_rank // 4,
           "bytes_per_rank": per_rank, "bound_ms": bound_ms}
    for label, kw in (("fp32", {}), ("int8", {"compression": "int8"})):
        b = GradBucketer(group=card, **kw)
        times = []
        for _ in range(2):  # cold, warm
            sync()
            t0 = time.perf_counter()
            synced = b.unflatten(trees, b.sync_async(trees).wait())
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            if len(times) == 1:
                del synced
        plan = b.last_plan
        algos = {}
        for bk in plan:
            algos[bk.algo] = algos.get(bk.algo, 0) + 1
        sizes = sorted(bk.nbytes for bk in plan)
        check(sum(sizes) == per_rank, f"{label} plan covers {sum(sizes)} of "
              f"{per_rank} bytes")
        # Each bucket's codec bound from its payloads' absmax per rank.
        leaf_bound = {}
        worst = 0.0
        if label == "int8":
            for bk in plan:
                amax = [max(float(_get(trees[r], k).abs().max())
                            for k in bk.names) for r in range(n)]
                tot = max(float(sum(_get(trees[r], k).to(card._devs[0])
                                    for r in range(n)).abs().max())
                          for k in bk.names)
                for k in bk.names:
                    leaf_bound[k] = (sum(amax) + tot) / 254 * (1 + 1e-5)
        for name, _a in named:
            total = _get(trees[0], name).clone()
            for r in range(1, n):
                total.add_(_get(trees[r], name).to(total.device))
            want = total / n
            for r in range(n):
                got = _get(synced[r], name).to(total.device)
                if label == "fp32":
                    # Per leaf, ||got / n - want|| / ||want||.
                    rel = float((got / n - want).norm() / want.norm())
                    worst = max(worst, rel)
                else:
                    err = float((got - total).abs().max())
                    check(err <= leaf_bound[name],
                          f"int8 sync {name} rank {r}: error {err:.4e} "
                          f"beyond the codec bound {leaf_bound[name]:.4e}")
                    worst = max(worst, err / leaf_bound[name])
        if label == "fp32":
            # The local route sums in rank order, as the one-place mean
            # does: the same bits. NCCL's ring sums in its own order, fp32
            # reassociation of n terms.
            lim = 0.0 if card.route == "local" else 1e-6
            check(worst <= lim, f"synced mean differs from the mean in one "
                  f"place by {worst:.3e} norm-relative")
        del synced
        gc.collect()
        print(f"  11b {label}: {len(plan)} buckets "
              f"({sizes[0]}..{sizes[-1]} B, {per_rank} B per rank), algos "
              f"{algos}; sync cold {times[0]:.1f} ms, warm {times[1]:.1f} "
              f"ms (bound {bound_ms:.2f} ms, route {card.route}); "
              + (f"mean vs one place, worst leaf norm-rel {worst:.3e}"
                 if label == "fp32" else
                 f"worst error / codec bound {worst:.3f}"))
        out[label] = {"buckets": len(plan), "bucket_bytes_min": sizes[0],
                      "bucket_bytes_max": sizes[-1], "algos": algos,
                      "cold_ms": times[0], "warm_ms": times[1],
                      ("norm_rel" if label == "fp32" else
                       "worst_over_bound"): worst}
    del trees
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _get(tree, name):
    """The leaf of ``tree`` at a bucketer key string (``['a']['b']``)."""
    for key in re.findall(r"\['([^']*)'\]", name):
        tree = tree[key]
    return tree


class NcclOne:
    """Phase 11c's num_gpus=1 actor."""

    def run(self):
        return nccl_world1()


def nccl_world1():
    """Phase 11c, in a num_gpus=1 actor: a world-1 group on NCCL (a real
    communicator over the runtime's rendezvous) runs every verb on CUDA
    tensors; then NCCL is asked for two ranks on the one card, and its
    answer is returned."""
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.collective import codec

    col.init_collective_group(1, 0, backend="nccl", group_name="p11_nccl")
    g = col.get_group("p11_nccl")
    x = torch.randn(1 << 16, device="cuda")
    res = {}

    def same(name, got, want):
        res[name] = bool(torch.equal(got, want))

    same("allreduce", col.allreduce(x, group_name="p11_nccl"), x)
    for op in ("max", "min", "product"):
        same(f"allreduce {op}", col.allreduce(x, group_name="p11_nccl",
                                              op=op), x)
    for algo in ("ring", "tree"):
        same(f"allreduce {algo}", col.allreduce(x, group_name="p11_nccl",
                                                algo=algo), x)
    same("allgather", col.allgather(x, group_name="p11_nccl"), x)
    same("reducescatter", col.reducescatter(x, group_name="p11_nccl"), x)
    same("broadcast", col.broadcast(x, group_name="p11_nccl"), x)
    part = col.allreduce(x, group_name="p11_nccl", min_ranks=1, grace_s=5.0)
    same("partial", part.value, x)
    res["partial skipped"] = part.skipped
    comp = col.allreduce(x, group_name="p11_nccl", compression="int8")
    q, s = codec.quantize_torch(x)
    same("compressed", comp,
         codec.dequantize_torch(q, s)[: x.numel()].reshape(x.shape))
    same("allreduce_async",
         col.allreduce_async(x, group_name="p11_nccl").wait(), x)
    col.barrier(group_name="p11_nccl")
    res["route"] = g.last_route
    col.destroy_collective_group("p11_nccl")
    try:
        from torch.cuda import nccl

        pair = [torch.ones(4, device="cuda:0"),
                torch.ones(4, device="cuda:0")]
        nccl.all_reduce(pair)
        torch.cuda.synchronize()
        res["two_ranks_one_card"] = f"accepted: {pair[0].tolist()}"
    except Exception as e:  # noqa: BLE001 - the answer is the result
        res["two_ranks_one_card"] = f"refused: {type(e).__name__}: {e}"
    return res


class GlooMember:
    """Phase 11c/d's half-GPU actors: a 2-rank "nccl" group over an
    explicit gloo backend on CUDA tensors, and the two ends of the
    device-object transport."""

    def __init__(self, rank):
        self.rank = rank

    def verbs(self, seed):
        from ray_tpu_torch import collective as col

        g = torch.Generator().manual_seed(seed + self.rank)
        x = torch.randn((64, 33), generator=g).cuda()
        out = {}
        for name, call in (
            ("allreduce", lambda: col.allreduce(x, group_name="p11_gloo")),
            ("allgather", lambda: col.allgather(x, group_name="p11_gloo")),
            ("reducescatter",
             lambda: col.reducescatter(x, group_name="p11_gloo")),
            ("partial", lambda: col.allreduce(
                x, group_name="p11_gloo", min_ranks=1, grace_s=30.0).value),
            ("compressed", lambda: col.allreduce(
                x, group_name="p11_gloo", compression="int8")),
        ):
            r = call()
            out[name] = (r.is_cuda, r.cpu().numpy())
        out["route"] = col.get_group("p11_gloo").last_route
        return out

    def make(self, nbytes, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(nbytes // 4, generator=g, device="cuda")
        sync()
        return x

    def fetch(self, refs, nbytes, seed):
        import ray_tpu_torch as rt

        t0 = time.perf_counter()
        x = rt.get(refs[0], timeout=300)
        sync()
        dt = time.perf_counter() - t0
        g = torch.Generator(device="cuda").manual_seed(seed)
        want = torch.randn(nbytes // 4, generator=g, device="cuda")
        return dt, x.is_cuda, bool(torch.equal(x, want))


def dist_and_transport(seed, timeout=600):
    """Phase 11c and 11d through the runtime."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import experimental

    out = {}
    rt.init(num_cpus=4)
    try:
        t0 = time.perf_counter()
        actor = rt.remote(num_gpus=1)(NcclOne).remote()
        one = rt.get(actor.run.remote(), timeout=timeout)
        rt.kill(actor)
        print(f"  11c world-1 NCCL group in a GPU actor "
              f"({time.perf_counter() - t0:.1f} s): {one}")
        verbs = [k for k, v in one.items() if isinstance(v, bool)]
        check(all(one[k] for k in verbs),
              f"the world-1 NCCL group failed {[k for k in verbs if not one[k]]}")
        check(one["route"] == "nccl", f"the NCCL group ran {one['route']}")
        out["nccl_world1"] = {"verbs": len(verbs), "route": one["route"],
                              "two_ranks_one_card":
                                  one["two_ranks_one_card"]}

        Member = rt.remote(num_gpus=0.5)(GlooMember)
        ms = [Member.remote(r) for r in range(2)]
        experimental.create_collective_group(
            ms, backend="nccl", group_name="p11_gloo", dist_backend="gloo")
        got = rt.get([m.verbs.remote(seed) for m in ms], timeout=timeout)
        xs = [torch.randn((64, 33), generator=torch.Generator()
                          .manual_seed(seed + r)).numpy() for r in range(2)]
        total = xs[0] + xs[1]
        want = {"allreduce": [total, total],
                "allgather": [np.concatenate(xs)] * 2,
                "reducescatter": [total[:32], total[32:]],
                "partial": [total, total]}
        for name, w in want.items():
            for r in range(2):
                on_card, v = got[r][name]
                check(on_card, f"gloo {name} came back off the card")
                np.testing.assert_allclose(v, w[r], rtol=1e-6, atol=1e-6,
                                           err_msg=f"gloo {name}")
        scale = float(np.abs(total).max())
        for r in range(2):
            err = float(np.abs(got[r]["compressed"][1] - total).max())
            check(err <= 2 * scale / 127,
                  f"gloo compressed allreduce off by {err}")
        check(all(g["route"] == "gloo:host" for g in got),
              f"the gloo group's CUDA tensors took {got[0]['route']}")
        print(f"  11c 2-rank gloo group on CUDA tensors (host-staged): "
              f"allreduce, allgather, reducescatter, partial, compressed "
              f"equal numpy's; route {got[0]['route']}")
        out["gloo_pair"] = {"verbs": 5, "route": got[0]["route"]}

        # 11d: the device-object transport, 256 MiB, RPC then group.
        transport = {}
        for label, how in (("rpc", True), ("group", "p11_gloo")):
            ref = ms[0].make.options(tensor_transport=how).remote(
                TRANSPORT_BYTES, seed + 7)
            dt, on_card, equal = rt.get(
                ms[1].fetch.remote([ref], TRANSPORT_BYTES, seed + 7),
                timeout=timeout)
            check(on_card and equal, f"the {label} transfer of "
                  f"{TRANSPORT_BYTES} B arrived on_card={on_card} "
                  f"equal={equal}")
            gbps = TRANSPORT_BYTES / dt / 1e9
            transport[label] = {"s": dt, "GB_per_s": gbps}
            print(f"  11d {label} path: {TRANSPORT_BYTES} B CUDA tensor to "
                  f"a second GPU actor in {dt:.3f} s ({gbps:.2f} GB/s), "
                  f"bits equal, on the card")
        out["transport"] = transport
        experimental.destroy_collective_group(ms, group_name="p11_gloo")
        for m in ms:
            rt.kill(m)
    finally:
        rt.shutdown()
    return out


def hier_check(card, seed):
    """Phase 11e: hierarchical_allreduce over 2 fake slices of 2 ranks of
    cuda:0 against the mesh group's flat allreduce; then with slice 1
    skipped (partial: slice 0's sum rescaled by 2 slices over 1)."""
    from ray_tpu_torch.collective import algo

    devs = algo.fake_slice_devices(2, ["cuda:0"] * P11_RANKS)
    xs = [x.cuda() for x in _p11_inputs(seed + 9, (1 << 20,), False,
                                        torch.float32)]
    flat = card.allreduce(xs)
    hier = algo.hierarchical_allreduce(xs, devices=devs, group="p11_hier")
    sync()
    diff = max(float((h - f).abs().max()) for h, f in zip(hier, flat))
    scale = float(flat[0].abs().max())
    check(diff <= 1e-5 * (1 + scale), f"hierarchical vs flat: {diff:.3e}")
    part = algo.hierarchical_allreduce(xs, devices=devs, group="p11_hier",
                                       min_slices=1, skip_slices=[1])
    want = (xs[0] + xs[1]) * 2.0
    pdiff = max(float((v - want).abs().max()) for v in part.value)
    check(part.skipped == [1] and part.contributed == [0]
          and pdiff <= 1e-5 * (1 + float(want.abs().max())),
          f"hierarchical partial: skipped {part.skipped}, off by {pdiff}")
    comp = algo.hierarchical_allreduce(xs, devices=devs, group="p11_hier",
                                       compression="int8")
    cdiff = max(float((c - f).abs().max()) for c, f in zip(comp, flat))
    check(cdiff <= 2 * scale / 127, f"hierarchical int8 off by {cdiff}")
    print(f"  11e hierarchical over 2 fake slices of 2 ranks: vs flat "
          f"{diff:.3e}; slice 1 skipped: slice 0 rescaled, off by "
          f"{pdiff:.3e}; int8 inter-slice hop off by {cdiff:.3e} (bound "
          f"{2 * scale / 127:.3e})")
    return {"vs_flat": diff, "partial_vs_rescaled": pdiff, "int8": cdiff}


def phase11(seed):
    print("phase 11: the collective data plane and the device-object "
          "transport")
    card, mesh = mesh_verbs(seed)
    buckets = bucket_sync(card, seed)
    hier = hier_check(card, seed)
    dist_t = dist_and_transport(seed)
    return {"mesh": dict(mesh, route=card.route, ranks=P11_RANKS),
            "bucketer": buckets, "hierarchical": hier, **dist_t}


# ----------------------------------------------------------- phase 12
# The Train library on the card: the bench preset's state through the
# shard store, then TorchTrainer with one worker and with two.
# Two steps, a save, two resumed steps: the checks need no more, and the
# whole run stays under 1000 s.
P12_STEPS, P12_SAVE_AT = 4, 2
P12_BATCH, P12_SEQ = 16, 2048  # phase 4's batch
P12_POOL_BYTES = 24 << 30  # the node's shm pool: two saves of 4.446 GB fit
# Depth of the trainer, Data and Tune runs (12b, 15b, 16): the bench preset
# at full width with P12_LAYERS of its 24 layers (all 24 before phases 18
# and 19 came: their time is fits, persists and restores of the state,
# which shrink with it). 12a saves and restores a state of that depth too;
# 12c restores 12b's checkpoint.
P12_LAYERS = 6


def p12_batch(cfg, seed, i):
    """Step ``i``'s batch, drawn from (seed, i): a resumed run sees the
    uninterrupted run's batches."""
    rng = np.random.default_rng([seed, i])
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (P12_BATCH, P12_SEQ + 1),
        dtype=np.int64)).to("cuda")}


def p12_config(layers=P12_LAYERS):
    """The bench preset (flash, remat flash_qkv) at ``layers`` layers (None:
    all of them) and phase 7's optimizer (bf16 first moment) without
    warm-up: the first update already runs at the full learning rate and
    moves every parameter."""
    from ray_tpu_torch.models.llama import PRESETS
    from ray_tpu_torch.train import make_optimizer

    cfg = dataclasses.replace(PRESETS["bench"], attn_impl="flash")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg, make_optimizer(lr=3e-4, warmup=0, total_steps=P12_STEPS,
                               mu_dtype=torch.bfloat16)


def p12_setup(seed, layers=P12_LAYERS):
    """p12_config and its train state from the seed."""
    from ray_tpu_torch.train import init_train_state

    cfg, opt = p12_config(layers)
    return cfg, opt, init_train_state(cfg, opt, seed=seed, device="cuda")


def p12_steps(cfg, opt, state, seed, stop, on_step=None):
    """Steps ``state.step`` .. ``stop`` - 1, each ending in a sync; each
    step's flash launches counted (24 + 24 for the bench preset). Calls
    ``on_step(state, metrics)`` after each. Returns the state and per step
    (loss, grad_norm, wall s, F1, F2)."""
    from ray_tpu_torch.train import jit_train_step

    step = jit_train_step(cfg, opt)
    out = []
    while state.step < stop:
        data = p12_batch(cfg, seed, state.step)
        reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, data)
        sync()
        wall = time.perf_counter() - t0
        _, f1, f2 = counts()
        out.append((float(m["loss"]), float(m["grad_norm"]), wall, f1, f2))
        if on_step is not None:
            on_step(state, m)
    return state, out


def p12_mismatched(state, uri):
    """``state`` held leaf by leaf against checkpoint ``uri`` restored to
    the host (no target): how many leaves differ from the saved leaf (a
    DTensor from its window of it) in dtype or in any bit, and how many
    leaves are sharded."""
    from ray_tpu_torch import checkpoint as dc
    from ray_tpu_torch.checkpoint import manifest
    from torch.distributed.tensor import DTensor

    saved = dc.restore_uri(uri)
    shards = mismatched = 0
    for key, leaf in manifest.tree_flatten_with_keys(state):
        want = saved[key]
        if not isinstance(leaf, torch.Tensor):
            mismatched += leaf != want.item()
            continue
        if isinstance(leaf, DTensor):
            window = manifest.dtensor_window(leaf)
            want = want[tuple(slice(a, b) for a, b in window)]
            leaf = leaf.to_local()
            shards += leaf.numel() < saved[key].numel()
        mismatched += not (leaf.dtype == want.dtype
                           and torch.equal(leaf.cpu(), want))
    return mismatched, shards


def p12_leaf_specs(state):
    """Each leaf's (global shape, dtype name) as a checkpoint manifest
    records it."""
    from ray_tpu_torch.checkpoint import manifest

    specs = {}
    for key, leaf in manifest.tree_flatten_with_keys(state):
        host = manifest.local_shards(leaf)[0][1]
        shape = getattr(leaf, "shape", None)
        specs[key] = (list(host.shape if shape is None else shape),
                      manifest.dtype_name(host))
    return specs


def p12_worker_loop(config):
    """TorchTrainer's loop for phase 12b: the bench state from the seed,
    resumed from get_checkpoint() when there is one (a ckpt:// URI; the
    resumed state, moments and step included, then held bit for bit
    against the checkpoint), trained to config["stop"], checkpointed into
    the shard store at config["save_at"] (report(checkpoint=uri));
    reports every step's (loss, grad_norm, wall, F1, F2) since the fit
    began, where it resumed from, how many resumed leaves differ from the
    checkpoint and the loop's own seconds."""
    import ray_tpu_torch.train as train
    from ray_tpu_torch import checkpoint as dc

    t0 = time.perf_counter()
    seed = config["seed"]
    cfg, opt, state = p12_setup(seed)
    restored, mismatched = train.get_checkpoint(), None
    if restored is not None:
        state = dc.restore_uri(restored, target=state)
        mismatched, _ = p12_mismatched(state, restored)
    saver = dc.AsyncCheckpointer()

    def on_step(st, _metrics):
        uri = (saver.save(st.step, st) if st.step == config["save_at"]
               else None)
        train.report({"step": st.step}, checkpoint=uri)

    state, steps = p12_steps(cfg, opt, state, seed, config["stop"], on_step)
    saver.wait()
    train.report({"step": state.step, "steps": steps,
                  "resumed_from": restored, "mismatched": mismatched,
                  "loop_s": time.perf_counter() - t0})


def p12_two_worker_loop(config):
    """TorchTrainer's loop for phase 12c, on each of two workers (an fsdp=2
    mesh over the trainer's default gloo group, both on cuda:0): phase
    12b's step-2 checkpoint restored onto fsdp=2 DTensors (each local shard
    bit for bit its slice of the saved leaf); then the bench preset's first
    two steps at TWO_RANK_LAYERS under fsdp=2 (rank_train); that state
    saved into the shard store from both ranks (each its windows)."""
    import ray_tpu_torch.train as train
    from ray_tpu_torch import checkpoint as dc
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.train import init_train_state

    ctx = train.get_context()
    cfg, opt = p12_config()
    target = init_train_state(cfg, opt, seed=config["seed"] + 2,
                              device="cuda", mesh=make_mesh({"fsdp": 2}))
    t0 = time.perf_counter()
    state = dc.restore_uri(config["uri"], target=target)
    restore_s = time.perf_counter() - t0
    del target
    mismatched, shards = p12_mismatched(state, config["uri"])
    del state
    gc.collect()
    torch.cuda.empty_cache()
    run = rank_train(config["seed"], {"fsdp": 2}, keep_state=True)
    saver = dc.AsyncCheckpointer(run=config["run"], rank=ctx.rank,
                                 world=ctx.world_size)
    saver.save(run["state"].step, run.pop("state"))
    saver.wait()
    train.report({"restore_s": restore_s, "shards": shards,
                  "mismatched": mismatched, "losses": run["losses"],
                  "norms": run["norms"], "f1": run["f1"], "f2": run["f2"],
                  "windows_bytes": saver.last["logical_bytes"]})


def phase12(seed, p4):
    """The Train library on the port's runtime (ray_tpu_torch.init).
    (a) the bench state at P12_LAYERS layers saved through AsyncCheckpointer:
    the seconds save() stalls the caller (the device-to-host copy) beside
    phase 7's torch.save, the background persist's seconds, logical and
    written bytes; saved again after one step at the full learning rate
    (the dedup ratio); restored into a fresh state, bit for bit. (b)
    TorchTrainer with one worker (one GPU) trains the bench preset 2
    steps, checkpointing through report(checkpoint=uri) into the store; a
    second fit resumes ("auto") for steps 3-4 from a state bit for bit
    the checkpoint: losses within 2^-8 relative of an uninterrupted
    4-step run in this process (phase 7's rule), 24 F1 and 24 F2 launches
    per step; tokens/s through the trainer and the controller's seconds
    per step. (c) TorchTrainer with two half-GPU workers, distributed
    over gloo on an fsdp=2 mesh: (b)'s step-2 checkpoint restored
    resharded (each rank's local shard bit for bit its slice), the bench preset's
    first two steps at TWO_RANK_LAYERS under fsdp=2 (losses and gradient
    norms within TWO_RANK_LOSS_REL / TWO_RANK_NORM_REL of one process),
    the state checkpointed from both ranks."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import checkpoint as dc
    from ray_tpu_torch.train import (
        RunConfig,
        ScalingConfig,
        TorchTrainer,
        init_train_state,
        train_state_dict,
    )

    print("phase 12: the Train library on the runtime (shard-store "
          "checkpoints, TorchTrainer)")
    out = {}
    rt.init(num_cpus=4, _system_config={"POOL_BYTES": P12_POOL_BYTES})
    try:
        # (a) the bench state through the shard store.
        cfg, opt, state = p12_setup(seed)
        cp = dc.AsyncCheckpointer(run="phase12a", replication=1)
        stalls = []
        for label in ("first save (host buffers allocated)", "after a step"):
            if stalls:
                state, _ = p12_steps(cfg, opt, state, seed, 1)
            sync()
            t0 = time.perf_counter()
            uri = cp.save(state.step, state)
            stalls.append(time.perf_counter() - t0)
            t1 = time.perf_counter()
            cp.wait()
            last = dict(cp.last, wait_s=time.perf_counter() - t1)
            ratio = 1 - last["new_bytes"] / last["logical_bytes"]
            print(f"  12a {label}: save() stalled the caller "
                  f"{stalls[-1]:.3f} s; persist {last['persist_s']:.2f} s "
                  f"(offload to commit {last['replication_lag_s']:.2f} s), "
                  f"{last['logical_bytes']} logical bytes, "
                  f"{last['new_bytes']} written, {last['chunks']} chunks, "
                  f"dedup ratio {ratio:.3f}")
            check(last["complete"], f"{uri} did not commit complete")
        out["a"] = {"stall_s": stalls, "persist_s": last["persist_s"],
                    "lag_s": last["replication_lag_s"],
                    "logical_bytes": last["logical_bytes"],
                    "written_bytes": last["new_bytes"], "dedup": ratio,
                    "uri": uri}
        saved = train_state_dict(state)
        fresh = init_train_state(cfg, opt, seed=seed + 1, device="cuda")
        t0 = time.perf_counter()
        back = train_state_dict(dc.restore_uri(uri, target=fresh))
        sync()
        out["a"]["restore_s"] = time.perf_counter() - t0
        check(back.keys() == saved.keys() and all(
            back[k].dtype == saved[k].dtype and back[k].device ==
            saved[k].device and torch.equal(back[k], saved[k])
            for k in saved), "12a: the restored state differs from the "
              "saved one")
        print(f"  12a restore into a fresh state: "
              f"{out['a']['restore_s']:.2f} s, bit for bit the saved one")
        del state, fresh, saved, back
        gc.collect()
        torch.cuda.empty_cache()

        # (b) one worker, resumed from the store.
        cfg, opt, state = p12_setup(seed)
        _, whole = p12_steps(cfg, opt, state, seed, P12_STEPS)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_p12_") as tmp:
            fits = []
            for stop, save_at, resume in ((P12_SAVE_AT, P12_SAVE_AT, None),
                                          (P12_STEPS, None, "auto")):
                t0 = time.perf_counter()
                res = TorchTrainer(
                    p12_worker_loop,
                    train_loop_config={"seed": seed, "stop": stop,
                                       "save_at": save_at},
                    scaling_config=ScalingConfig(
                        num_workers=1, use_gpu=True, gpus_per_worker=1),
                    run_config=RunConfig(name="phase12b", storage_path=tmp,
                                         resume_from_checkpoint=resume),
                ).fit()
                check(res.error is None, f"12b fit failed: {res.error!r}")
                fits.append((res, time.perf_counter() - t0))
        (first, first_s), (second, second_s) = fits
        check(first.checkpoint == f"ckpt://phase12b/{P12_SAVE_AT}"
              and second.metrics["resumed_from"] == first.checkpoint,
              f"12b: fit 1 left {first.checkpoint}, fit 2 resumed from "
              f"{second.metrics['resumed_from']}")
        check(second.metrics["mismatched"] == 0,
              f"12b: {second.metrics['mismatched']} leaves of the resumed "
              f"state differ from the checkpoint")
        steps = first.metrics["steps"] + second.metrics["steps"]
        rel = [abs(a[0] / b[0] - 1) for a, b in zip(steps, whole)]
        print("  12b uninterrupted losses: "
              + ", ".join(f"{r[0]:.6f}" for r in whole))
        print("  12b through TorchTrainer, resumed at step "
              f"{P12_SAVE_AT} from a state bit for bit the checkpoint: "
              + ", ".join(f"{r[0]:.6f}" for r in steps)
              + f"; largest relative difference {max(rel):.3e} (limit "
              f"2^-8)")
        check(len(steps) == P12_STEPS and all(r <= 2**-8 for r in rel),
              "12b: the resumed trainer's losses leave the uninterrupted "
              "run's")
        check(all(r[3] == r[4] == cfg.n_layers for r in steps),
              f"12b: F1/F2 launches per step "
              f"{[(r[3], r[4]) for r in steps]}, expected "
              f"{cfg.n_layers} each")
        walls = [r[2] for r in first.metrics["steps"][1:]
                 + second.metrics["steps"][1:]]
        tps = P12_BATCH * P12_SEQ * len(walls) / sum(walls)
        overhead = (first_s + second_s - first.metrics["loop_s"]
                    - second.metrics["loop_s"]) / P12_STEPS
        print(f"  12b TorchTrainer ({cfg.n_layers} layers): {tps:.1f} "
              f"tokens/s (steps after each fit's first; phase 4 at 24 "
              f"layers {p4['tokens_per_s']:.1f}), fits "
              f"{first_s:.1f} s + {second_s:.1f} s, the controller's "
              f"{overhead:.2f} s per step (fit walls less the loops' own "
              f"seconds, over {P12_STEPS} steps); F1 + F2 launches per "
              f"step {steps[0][3]} + {steps[0][4]}")
        out["b"] = {"tokens_per_s": tps, "overhead_s": overhead,
                    "max_rel": max(rel), "launches": [r[3:] for r in steps],
                    "fit_s": [first_s, second_s],
                    "whole": [r[0] for r in whole]}

        # (c) two workers on one card, fsdp=2 over gloo, held to the same
        # two steps in this process.
        single = rank_train(seed, None, keep_state=True)
        specs = p12_leaf_specs(single.pop("state"))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_p12c_") as tmp:
            res = TorchTrainer(
                p12_two_worker_loop,
                train_loop_config={"seed": seed, "uri": first.checkpoint,
                                   "run": "phase12c"},
                scaling_config=ScalingConfig(
                    num_workers=2, use_gpu=True, gpus_per_worker=0.5,
                    distributed=True, dist_backend="gloo"),
                run_config=RunConfig(name="phase12c", storage_path=tmp),
            ).fit()
        check(res.error is None, f"12c fit failed: {res.error!r}")
        m = res.metrics
        check(m["mismatched"] == 0 and m["shards"] > 0,
              f"12c: {m['mismatched']} restored leaves differ from their "
              f"slices of the saved ones ({m['shards']} sharded)")
        print(f"  12c: 12b's checkpoint restored onto fsdp=2 in "
              f"{m['restore_s']:.2f} s (rank 0), {m['shards']} leaves "
              f"sharded, every local shard bit for bit its slice")
        for i, (loss, norm) in enumerate(zip(m["losses"], m["norms"])):
            want, want_norm = single["losses"][i], single["norms"][i]
            rl, rn = abs(loss / want - 1), abs(norm / want_norm - 1)
            print(f"  12c step {i}: loss {loss:.6f} (one process "
                  f"{want:.6f}, rel {rl:.2e}), grad_norm {norm:.6f} "
                  f"({want_norm:.6f}, rel {rn:.2e})")
            check(rl <= TWO_RANK_LOSS_REL and rn <= TWO_RANK_NORM_REL,
                  f"12c step {i}: off one process beyond "
                  f"{TWO_RANK_LOSS_REL} / {TWO_RANK_NORM_REL}")
        layers = two_rank_bench().n_layers
        check(m["f1"] == m["f2"] == 2 * layers,
              f"12c: rank 0 launched F1 {m['f1']} and F2 {m['f2']} "
              f"times in two steps, expected {2 * layers} each")
        # The two ranks' manifests, merged at the head, cover every leaf
        # of the bench state whole (checked from the windows, without
        # pulling the chunks); one sharded leaf and the step restored.
        core = rt.api._runtime

        def entries(run):
            reply = core.run(core.core.head.call("ckpt_manifest", run=run,
                                                 step=None))
            check(reply.get("ok"), f"12c: no complete checkpoint of {run}")
            return reply["entries"]

        two = entries("phase12c")
        check(two.keys() == specs.keys() and all(
            (e["shape"], e["dtype"]) == specs[k]
            and sum(math.prod(b - a for a, b in sh["index"])
                    if sh.get("index") else math.prod(e["shape"])
                    for sh in e["shards"]) == math.prod(e["shape"])
            for k, e in two.items()),
            "12c: the two ranks' checkpoint is not the whole state they "
            "trained")
        emb = ".params['tok_emb']"
        part = dc.restore("phase12c", keys=[emb, ".step"])
        check(int(part[".step"]) == 2 and bool(torch.isfinite(
            part[emb]).all()) and len(two[emb]["shards"]) == 2,
              f"12c: the restored step {part['.step']} or {emb} "
              f"({len(two[emb]['shards'])} windows)")
        print(f"  12c: the state after 2 steps checkpointed from both ranks "
              f"(rank 0 wrote {m['windows_bytes']} bytes of windows): "
              f"{len(two)} leaves whole in the merged manifest, {emb} "
              f"restored from its 2 windows; fit "
              f"{time.perf_counter() - t0:.1f} s")
        out["c"] = {"losses": m["losses"], "norms": m["norms"],
                    "restore_s": m["restore_s"], "single": single["losses"]}
    finally:
        rt.shutdown()
    return out


# ------------------------------------------------------------ phase 13
P13_TOKENS = 32  # greedy tokens per request, as phase 2
P13_ENGINE = {"max_batch": 8, "max_seq": 2048, "page_size": 64}


def wait_free_gpu(want, timeout=120.0):
    """The cluster's available GPU once it reads ``want`` (or the last
    reading at the deadline)."""
    import ray_tpu_torch as rt

    deadline = time.monotonic() + timeout
    while True:
        free = rt.available_resources().get("GPU", 0.0)
        if free == want or time.monotonic() > deadline:
            return free
        time.sleep(0.2)


def http_llm(port, route, body, stream):
    """One request to the HTTP proxy, timed from the send: the unary JSON
    answer, or an SSE stream's token deltas (which must end in
    ``data: [DONE]``). Returns {"tokens", "first_s", "last_s",
    "engine_ttft_s", "deltas"}; for a unary answer first_s and last_s are
    the answer's arrival."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {"Content-Type": "application/json"}
    if stream:
        headers["Accept"] = "text/event-stream"
    t0 = time.perf_counter()
    conn.request("POST", route, body=json.dumps(
        {**body, "stream": stream}), headers=headers)
    resp = conn.getresponse()
    check(resp.status == 200, f"HTTP {resp.status} from the proxy")
    if not stream:
        out = json.loads(resp.read())
        t = time.perf_counter() - t0
        conn.close()
        return {"tokens": out["tokens"], "first_s": t, "last_s": t,
                "engine_ttft_s": out["ttft_s"], "deltas": 1}
    buf, tokens, deltas, done = b"", [], 0, False
    first = last = None
    while not done:
        chunk = resp.read1(65536)
        if not chunk:
            break
        now = time.perf_counter() - t0
        buf += chunk
        while b"\n\n" in buf:
            event, buf = buf.split(b"\n\n", 1)
            lines = event.decode().splitlines()
            check("event: error" not in lines, f"SSE error event: {lines}")
            for line in lines:
                data = line.removeprefix("data: ")
                if data == line:
                    continue
                if data == "[DONE]":
                    done = True
                    continue
                delta = json.loads(data)["tokens"]
                if delta:
                    first = now if first is None else first
                    last = now
                    deltas += 1
                tokens += delta
    conn.close()
    check(done, "an SSE stream did not end in data: [DONE]")
    return {"tokens": tokens, "first_s": first, "last_s": last,
            "engine_ttft_s": None, "deltas": deltas}


def replica_stats(app, deployment, timeout=120):
    """Each live replica's (pid, its LLMServer's engine stats), called on
    that replica alone (the replicas from the controller's routing
    list)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.api import ActorHandle
    from ray_tpu_torch.serve.handle import CONTROLLER_NAME

    controller = rt.get_actor(CONTROLLER_NAME)
    _version, replicas = rt.get(controller.get_replicas.remote(deployment,
                                                               app))
    out = []
    for actor_id, addr, _ in replicas:
        rep = ActorHandle(actor_id, addr, "Replica")
        pid = rt.get(rep.get_stats.remote(), timeout=timeout)["pid"]
        stats = rt.get(rep.handle_request.remote("stats", (), {}, None),
                       timeout=timeout)
        out.append((pid, stats))
    return out


def p1_launches_check(label, stats, cfg):
    """A replica's P1 launches (its process's count, 0 when the process
    started) against its engine's decode steps: one per layer per step,
    and at least one step."""
    p1 = stats["kernel_launches"]["paged_attention"]
    steps = stats["decode_steps"]
    check(steps > 0 and p1 == cfg.n_layers * steps,
          f"{label}: P1 launched {p1} times for {steps} decode steps x "
          f"{cfg.n_layers} layers")
    return p1, steps


def phase13a(seed, p2, serve, timeout=900):
    """llama3_8b from one whole-GPU replica behind the HTTP proxy."""
    from ray_tpu_torch.llm import build_llm_deployment
    from ray_tpu_torch.models.llama import PRESETS, init_params

    cfg = PRESETS["llama3_8b"]
    prompts = p2["prompts"]
    t0 = time.perf_counter()
    serve.run(build_llm_deployment(
        "llama3_8b", engine_kwargs={**P13_ENGINE, "seed": seed},
        ray_actor_options={"num_gpus": 1}),
        name="llm", route_prefix="/llm", timeout_s=timeout)
    port = serve.start_http()
    http_llm(port, "/llm", {"prompt": prompts[0], "max_tokens": 1}, False)
    cold_s = time.perf_counter() - t0
    check(wait_free_gpu(0.0) == 0.0,
          "the llama3_8b replica does not hold the GPU")

    def burst(max_tokens):
        """Phase 2's 8 prompts at once: even ones unary, odd ones SSE."""
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            futs = [pool.submit(http_llm, port, "/llm",
                                {"prompt": p, "max_tokens": max_tokens},
                                i % 2 == 1)
                    for i, p in enumerate(prompts)]
            return [f.result() for f in futs]

    burst(2)  # warm-up, as phase 2's: cuBLAS picks kernels per shape
    outs = burst(P13_TOKENS)
    [(_pid, stats)] = replica_stats("llm", "LLMServer")
    check(all(len(o["tokens"]) == P13_TOKENS for o in outs),
          "a served request did not finish with 32 tokens")
    p1, steps = p1_launches_check("13a replica", stats, cfg)
    sse = [o for i, o in enumerate(outs) if i % 2 == 1]
    unary = [o for i, o in enumerate(outs) if i % 2 == 0]
    check(all(o["deltas"] > 1 for o in sse),
          "an SSE stream arrived in one frame")
    ttft = [o["first_s"] for o in sse]
    engine_ttft = [o["engine_ttft_s"] for o in unary]
    per_stream = [(len(o["tokens"]) - 1) / (o["last_s"] - o["first_s"])
                  for o in sse]
    serve.delete("llm")
    check(wait_free_gpu(1.0) == 1.0,
          "the GPU did not come back after the llama3_8b deployment")
    streams = [o["tokens"] for o in outs]
    params = init_params(cfg, seed, device="cuda", dtype=cfg.dtype)
    stream_check(cfg, params, prompts, streams, "13a served llama3_8b")
    same = sum(a == b for a, b in zip(streams, p2["outs"]))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  13a: llama3_8b replica cold start (serve.run to its first "
          f"answer) {cold_s:.2f} s; P1 {p1} launches for {steps} decode "
          f"steps; F1 {stats['kernel_launches']['flash_attention_forward']}; "
          f"client TTFT over the 4 SSE streams mean "
          f"{float(np.mean(ttft)):.3f} s, max {float(np.max(ttft)):.3f} s; "
          f"engine ttft_s over the 4 unary mean "
          f"{float(np.mean(engine_ttft)):.3f} s, max "
          f"{float(np.max(engine_ttft)):.3f} s; SSE decode per stream "
          f"{float(np.mean(per_stream)):.1f} tokens/s (phase 2 in process "
          f"{p2['decode_tokens_per_s'] / len(prompts):.1f} per stream of "
          f"{p2['decode_tokens_per_s']:.1f} over 8); {same} of 8 streams "
          f"equal phase 2's")
    return {"cold_s": cold_s, "ttft_mean": float(np.mean(ttft)),
            "ttft_max": float(np.max(ttft)),
            "engine_ttft_mean": float(np.mean(engine_ttft)),
            "engine_ttft_max": float(np.max(engine_ttft)),
            "sse_tokens_per_s": float(np.mean(per_stream)),
            "p1": p1, "steps": steps}


def phase13b(seed, m2, serve, timeout=600):
    """mini as two half-GPU replicas behind a DeploymentHandle, one of
    them SIGKILLed under load."""
    import threading

    from ray_tpu_torch._private.test_utils import kill_one_replica
    from ray_tpu_torch.llm import build_llm_deployment
    from ray_tpu_torch.models.llama import PRESETS, init_params

    cfg = PRESETS["mini"]
    handle = serve.run(build_llm_deployment(
        "mini", num_replicas=2, engine_kwargs={**P13_ENGINE, "seed": seed},
        ray_actor_options={"num_gpus": 0.5}),
        name="mini", route_prefix="/mini", timeout_s=timeout)
    check(wait_free_gpu(0.0) == 0.0,
          "two half-GPU replicas do not hold the whole GPU")
    prompts = list(m2["prompts"]) * 2
    futs = [handle.generate.remote(p, max_tokens=P13_TOKENS)
            for p in prompts]
    outs = [f.result(timeout=timeout)["tokens"] for f in futs]
    check(all(len(o) == P13_TOKENS for o in outs),
          "a mini request did not finish with 32 tokens")
    before = replica_stats("mini", "LLMServer")
    check(len(before) == 2, f"{len(before)} mini replicas, not 2")
    for pid, st in before:
        check(st["requests_finished"] > 0,
              f"the mini replica of pid {pid} answered no request")
        p1_launches_check(f"13b replica {pid}", st, cfg)

    # SIGKILL one replica under unary load: every request still answers.
    rng = np.random.default_rng(seed + 13)
    kill_prompts = serving_prompts(cfg, rng, (20, 63, 200, 511) * 6)
    kill_outs, errors = [None] * len(kill_prompts), []

    def traffic():
        for i, p in enumerate(kill_prompts):
            try:
                kill_outs[i] = handle.generate.remote(
                    p, max_tokens=8).result(timeout=120)["tokens"]
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    time.sleep(0.5)
    killed = kill_one_replica("LLMServer", "mini")
    t.join(timeout=300)
    check(not t.is_alive(), "unary traffic hung after the replica SIGKILL")
    check(not errors and all(o is not None and len(o) == 8
                             for o in kill_outs),
          f"requests failed across the replica SIGKILL: {errors[:3]}")
    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout
    while True:
        st = serve.status()["mini"]["LLMServer"]
        if st["replicas"] == 2 and st["status"] == "HEALTHY":
            break
        check(time.monotonic() < deadline,
              f"no replacement replica after the SIGKILL: {st}")
        time.sleep(0.5)
    replace_s = time.perf_counter() - t0
    check(wait_free_gpu(0.0) == 0.0,
          "the replacement replica did not take its half GPU back")
    after = replica_stats("mini", "LLMServer")
    old_pids = {pid for pid, _ in before}
    check(len(after) == 2 and len({p for p, _ in after} - old_pids) == 1,
          f"replicas after the kill: pids {[p for p, _ in after]}, before "
          f"{sorted(old_pids)}")
    serve.shutdown()
    check(wait_free_gpu(1.0) == 1.0,
          "serve.shutdown() did not give the GPU back")
    params = init_params(cfg, seed, device="cuda", dtype=cfg.dtype)
    stream_check(cfg, params, prompts, outs, "13b mini through the handle")
    stream_check(cfg, params, kill_prompts, kill_outs,
                 "13b mini across the SIGKILL")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  13b: mini on 2 half-GPU replicas (pids "
          f"{sorted(old_pids)}): requests / P1 launches / decode steps "
          + ", ".join(f"{st['requests_finished']} / "
                      f"{st['kernel_launches']['paged_attention']} / "
                      f"{st['decode_steps']}" for _, st in before)
          + f"; SIGKILLed replica {killed[:12]}, {len(kill_prompts)} unary "
          f"requests all answered; replacement healthy in {replace_s:.2f} s, "
          f"available GPU 0.0 with 2 replicas, 1.0 after serve.shutdown()")
    return {"replace_s": replace_s,
            "launches": [st["kernel_launches"]["paged_attention"]
                         for _, st in before]}


def phase13(seed, p2, m2):
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    print("phase 13: Serve on the card: llama3_8b behind the HTTP proxy, "
          "mini on two half-GPU replicas")
    rt.init(num_cpus=8)
    try:
        check(rt.cluster_resources().get("GPU") == 1.0,
              "the cluster does not have the card's one GPU")
        a = phase13a(seed, p2, serve)
        b = phase13b(seed, m2, serve)
    finally:
        serve.shutdown()
        rt.shutdown()
    return {"a": a, "b": b}


# ------------------------------------------------------------ phase 14
P14_EXECUTES = 20


class FlashRank:
    """Phase 14's GPU actor: F1 at phase 10's shape on inputs drawn on
    the card from the seed the graph's input carries (plus its rank)."""

    def __init__(self, rank):
        self.rank = rank

    def reset(self):
        from ray_tpu_torch.ops.flash_attention import flash_attention_forward

        flash_attention_forward.launches = 0
        return os.getpid()

    def forward(self, seed):
        from ray_tpu_torch.ops.flash_attention import flash_attention_forward

        b, s, h, hkv, d = PHASE10_SHAPE
        q, k, v, _ = flash_inputs(b, s, torch.bfloat16, seed + self.rank,
                                  h=h, hkv=hkv, d=d)
        return flash_attention_forward(q, k, v, True)[0]

    def norm(self, seed):
        """F1 as in forward, returning O's norm only (a 0-d tensor)."""
        return self.forward(seed).float().norm()

    def launches(self):
        from ray_tpu_torch.ops.flash_attention import flash_attention_forward

        return flash_attention_forward.launches


def _children():
    """Live (non-zombie) child processes of this process."""
    me, out = os.getpid(), set()
    for stat in glob.glob("/proc/[0-9]*/stat"):
        try:
            with open(stat) as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            out.add(int(stat.split("/")[2]))
    return out


def time_graph(cdag, seed, timeout=600):
    """Microseconds per ``execute(...).get()`` over P14_EXECUTES, each
    on a new seed."""
    t0 = time.perf_counter()
    for i in range(P14_EXECUTES):
        cdag.execute(seed + 2 * i).get(timeout=timeout)
    return (time.perf_counter() - t0) / P14_EXECUTES * 1e6


def time_remote(ranks, method, seed, timeout=600):
    """Microseconds per round of ``method`` on every rank by ``.remote()``
    and one ``get``, over P14_EXECUTES rounds."""
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    for i in range(P14_EXECUTES):
        rt.get([getattr(r, method).remote(seed + 2 * i) for r in ranks],
               timeout=timeout)
    return (time.perf_counter() - t0) / P14_EXECUTES * 1e6


def phase14(seed, timeout=600):
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode, MultiOutputNode, allreduce
    from ray_tpu_torch.dag.channel import _pack
    from ray_tpu_torch.ops.flash_attention import flash_attention_forward

    print("phase 14: a compiled graph: F1 in two half-GPU actors, their "
          "outputs allreduced")
    before = _children()
    info = rt.init(num_cpus=4)
    try:
        ranks = [rt.remote(num_gpus=0.5)(FlashRank).remote(r)
                 for r in range(2)]
        rt.get([r.reset.remote() for r in ranks], timeout=timeout)
        with InputNode() as inp:
            outs = allreduce.bind([r.forward.bind(inp) for r in ranks])
            graph = MultiOutputNode(outs)
        cdag = graph.experimental_compile(buffer_size=16 << 20,
                                          max_buffered=2)
        chan_dir = cdag._chan_dir
        got = cdag.execute(seed).get(timeout=timeout)
        b, s, h, hkv, d = PHASE10_SHAPE
        want = sum(flash_attention_forward(*flash_inputs(
            b, s, torch.bfloat16, seed + r, h=h, hkv=hkv, d=d)[:3], True)[0]
            for r in range(2))
        for r, o in enumerate(got):
            check(o.is_cuda and o.dtype == torch.bfloat16
                  and o.shape == want.shape,
                  f"rank {r}'s reduced O is {o.dtype} {tuple(o.shape)} on "
                  f"{o.device}")
        check(torch.equal(got[0], got[1]),
              "the two ranks' allreduced outputs differ")
        (atol, rtol), norm = FLASH_ORACLE_TOL, FLASH_ORACLE_NORM
        compare("14 allreduced F1 O vs the driver's two calls", got[0], want,
                atol, rtol, norm)
        step_bytes = (len(_pack(((seed,), {})))
                      + sum(len(_pack(o)) for o in got))
        dag_us = time_graph(cdag, seed, timeout)
        cdag.teardown()
        launches = rt.get([r.launches.remote() for r in ranks],
                          timeout=timeout)
        check(launches == [1 + P14_EXECUTES] * 2,
              f"F1 launches per actor {launches}, not one per execute "
              f"({1 + P14_EXECUTES})")
        check(not os.path.exists(chan_dir),
              f"teardown left the channel directory {chan_dir}")
        # The same two calls, submitted and fetched task by task.
        remote_us = time_remote(ranks, "forward", seed, timeout)
        # Where the step's time goes: the graph without its collective
        # node (both O's straight to the driver), and a graph whose
        # outputs are O's norms (the per-step cost of dispatch alone),
        # beside the same norms by .remote().
        split = {}
        for label, method in (("no allreduce", "forward"),
                              ("norms", "norm")):
            with InputNode() as inp:
                graph = MultiOutputNode([getattr(r, method).bind(inp)
                                         for r in ranks])
            cdag = graph.experimental_compile(buffer_size=16 << 20,
                                              max_buffered=2)
            cdag.execute(seed).get(timeout=timeout)
            split[label] = time_graph(cdag, seed, timeout)
            cdag.teardown()
        split["norms by .remote()"] = time_remote(ranks, "norm", seed,
                                                  timeout)
        for r in ranks:
            rt.kill(r)
    finally:
        rt.shutdown()
    segments = glob.glob(f"/dev/shm/ray_tpu_torch-{info['session']}*")
    check(not segments, f"store segments left behind: {segments}")
    deadline = time.monotonic() + 15
    while (_children() - before) and time.monotonic() < deadline:
        time.sleep(0.2)
    check(not (_children() - before),
          f"worker processes left behind: {sorted(_children() - before)}")
    print(f"  14: {dag_us:.1f} us per execute() over {P14_EXECUTES} "
          f"(F1 twice, allgather of two {want.nbytes} B outputs, reduce), "
          f"{step_bytes} B through the shared-memory channels per step; "
          f"the same two F1 calls by .remote() and get: {remote_us:.1f} us; "
          f"F1 launches per actor {launches}; us per step: "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
    return {"dag_us": dag_us, "remote_us": remote_us, "split": split,
            "step_bytes": step_bytes, "launches": launches}


# ------------------------------------------------------------ phase 15
P15_STEPS = 3  # phase 12b's first three batches, read from a Dataset
P15_BLOCKS = 4  # blocks of the training Dataset: a batch spans two
P15_FREE_SLACK = 1 << 30  # bytes below phase 15's first reading


def card_free_again(want, timeout=120.0):
    """Whether the card's free bytes come back to ``want`` (phase 15's
    first reading, taken when phase 14 has left no worker process) less
    P15_FREE_SLACK within ``timeout``, and the last reading."""
    deadline = time.monotonic() + timeout
    while True:
        free = torch.cuda.mem_get_info()[0]
        if free >= want - P15_FREE_SLACK or time.monotonic() > deadline:
            return free >= want - P15_FREE_SLACK, free
        time.sleep(0.5)


def pid_alive(pid):
    """``pid`` names a live process (not a zombie)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def p15_inferencer(seed):
    """Phase 15a's map_batches class: the class build_batch_inferencer
    returns for llama3_8b (phase 13's engine, drawn from the seed in the
    data actor), with columns added for the driver to check: the token
    ids as a [rows, 32] int64 CUDA tensor (the block module turns it into
    host numpy), the device it came from, the engine's decode steps, the
    actor process's P1 and F1 launches in this call, the decode tokens/s
    of its steps (phase 2's measure), and the actor's pid."""
    from ray_tpu_torch.llm import build_batch_inferencer

    base = build_batch_inferencer(
        "llama3_8b", engine_kwargs={**P13_ENGINE, "seed": seed},
        max_tokens=P13_TOKENS)

    class Phase15Inferencer(base):
        def __call__(self, batch):
            eng = self.engine
            outs, walls, emitted = [], [], []
            generate, step = eng.generate, eng.step

            def recording_generate(prompts, sampling):
                outs.extend(generate(prompts, sampling))
                return outs

            def timed_step():
                before = eng.stats()["tokens_generated"]
                t0 = time.perf_counter()
                fins = step()
                sync()
                walls.append(time.perf_counter() - t0)
                emitted.append(eng.stats()["tokens_generated"] - before)
                return fins

            eng.generate, eng.step = recording_generate, timed_step
            steps0, (p1_0, f1_0, _) = eng.stats()["decode_steps"], counts()
            try:
                batch = super().__call__(batch)
            finally:
                del eng.generate, eng.step
            p1, f1, _ = counts()
            n = len(outs)
            tokens = torch.tensor(outs, dtype=torch.int64, device="cuda")
            batch["tokens"] = tokens
            batch["tokens_device"] = [str(tokens.device)] * n
            batch["decode_steps"] = np.full(
                n, eng.stats()["decode_steps"] - steps0)
            batch["p1"] = np.full(n, p1 - p1_0)
            batch["f1"] = np.full(n, f1 - f1_0)
            # All rows are admitted in the first step; the rest decode.
            batch["decode_tokens_per_s"] = np.full(
                n, sum(emitted[1:]) / sum(walls[1:]))
            batch["pid"] = np.full(n, os.getpid())
            return batch

    return Phase15Inferencer


def phase15a(seed, p2, free0, timeout=900):
    """llama3_8b batch inference through a data actor pool."""
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    from ray_tpu_torch.models.llama import PRESETS

    cfg = PRESETS["llama3_8b"]
    prompts = p2["prompts"]
    ok, free = card_free_again(free0)
    check(ok, f"15a: the card has {free} bytes free before the data actor, "
          f"not {free0}")
    ds = rd.from_items([{"prompt": p} for p in prompts],
                       parallelism=1)
    t0 = time.perf_counter()
    rows = ds.map_batches(p15_inferencer(seed), batch_size=len(prompts),
                          compute="actors", concurrency=1).take_all()
    rows_s = time.perf_counter() - t0
    check(len(rows) == len(prompts), f"15a: {len(rows)} rows, not "
          f"{len(prompts)}")
    check([list(r["prompt"]) for r in rows] == prompts,
          "15a: the rows' prompts are not phase 2's, in order")
    streams = [r["tokens"].tolist() for r in rows]
    check(all(isinstance(r["tokens"], np.ndarray)
              and r["tokens"].dtype == np.int64
              and r["tokens_device"].startswith("cuda") for r in rows),
          "15a: the token column did not arrive as int64 from a CUDA "
          "tensor")
    same = sum(a == b for a, b in zip(streams, p2["outs"]))
    check(same == len(prompts), f"15a: {same} of {len(prompts)} streams "
          f"equal phase 2's greedy streams")
    tok = ByteTokenizer()
    check([r["generated"] for r in rows]
          == [tok.decode(o) for o in p2["outs"]],
          "15a: the generated column is not phase 2's streams decoded")
    steps, p1, f1 = (int(rows[0][k]) for k in ("decode_steps", "p1", "f1"))
    check(steps > 0 and p1 == cfg.n_layers * steps,
          f"15a data actor: P1 launched {p1} times for {steps} decode "
          f"steps x {cfg.n_layers} layers")
    pid = int(rows[0]["pid"])
    deadline = time.monotonic() + 60
    while pid_alive(pid) and time.monotonic() < deadline:
        time.sleep(0.2)
    check(not pid_alive(pid), f"15a: the data actor (pid {pid}) outlived "
          f"the pool's teardown")
    ok, free1 = card_free_again(free0)
    check(ok, f"15a: the card has {free1} bytes free after the pool's "
          f"teardown, not {free0}")
    per_stream = float(rows[0]["decode_tokens_per_s"]) / len(prompts)
    print(f"  15a: map_batches(compute=\"actors\", concurrency=1).take_all()"
          f" to the rows {rows_s:.2f} s (the actor's start and the 16 GB "
          f"draw included); P1 {p1} launches for {steps} decode steps, F1 "
          f"{f1}; {same} of 8 streams equal phase 2's; decode "
          f"{per_stream:.1f} tokens/s per stream (phase 2 "
          f"{p2['decode_tokens_per_s'] / len(prompts):.1f}); the actor "
          f"(pid {pid}) gone after take_all(), card free "
          f"{free0 / 2**30:.2f} GiB before, {free1 / 2**30:.2f} GiB after")
    return {"rows_s": rows_s, "p1": p1, "f1": f1, "steps": steps,
            "per_stream": per_stream, "same": same}


def p15_train_loop(config):
    """TorchTrainer's loop for phase 15b: phase 12b's state from the seed,
    fed from this worker's shard of the Dataset in batches of P12_BATCH
    rows, each moved to the card inside the step_span's data_wait phase;
    reports each step's (loss, grad_norm, wall, data_wait s, F1, F2), a
    CRC of every row read, in order, and the rows past the steps."""
    import zlib

    import ray_tpu_torch.train as train
    from ray_tpu_torch.train import jit_train_step

    cfg, opt, state = p12_setup(config["seed"])
    step = jit_train_step(cfg, opt)
    it = iter(train.get_dataset_shard("train").iter_batches(
        batch_size=P12_BATCH))
    steps, crcs = [], []
    for _ in range(config["steps"]):
        with train.step_span(tokens=P12_BATCH * P12_SEQ,
                             flops_per_token=cfg.flops_per_token(P12_SEQ)
                             ) as span:
            with span.phase("data_wait"):
                rows = next(it)["data"]
                data = {"tokens": torch.from_numpy(rows).to("cuda")}
            reset_counts()
            with span.phase("compute"):
                t0 = time.perf_counter()
                state, m = step(state, data)
                sync()
                wall = time.perf_counter() - t0
            _, f1, f2 = counts()
        crcs += [zlib.crc32(r.tobytes()) for r in rows]
        steps.append((float(m["loss"]), float(m["grad_norm"]), wall,
                      span.phases.get("data_wait"), f1, f2))
    rest = sum(len(b["data"]) for b in it)
    train.report({"steps": steps, "crcs": crcs, "rest": rest})


def phase15b(seed, p12, free0):
    """A TorchTrainer fed by a Dataset of phase 12b's first batches."""
    import tempfile
    import zlib

    import ray_tpu_torch.data as rd
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    cfg, _ = p12_config()
    ok, free = card_free_again(free0)
    check(ok, f"15b: the card has {free} bytes free before the trainer, "
          f"not {free0}")
    rows = np.concatenate([p12_batch(cfg, seed, i)["tokens"].cpu().numpy()
                           for i in range(P15_STEPS)])
    ds = rd.from_numpy(rows, parallelism=P15_BLOCKS)
    check(ds.num_blocks() == P15_BLOCKS, "15b: the Dataset's blocks")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p15_") as tmp:
        res = TorchTrainer(
            p15_train_loop,
            train_loop_config={"seed": seed, "steps": P15_STEPS},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                         gpus_per_worker=1),
            run_config=RunConfig(name="phase15b", storage_path=tmp),
            datasets={"train": ds},
        ).fit()
    fit_s = time.perf_counter() - t0
    check(res.error is None, f"15b fit failed: {res.error!r}")
    steps, m = res.metrics["steps"], res.metrics
    check(m["crcs"] == [zlib.crc32(r.tobytes()) for r in rows]
          and m["rest"] == 0,
          f"15b: the rows read ({len(m['crcs'])}, {m['rest']} left over) "
          f"are not the Dataset's {len(rows)} rows, each once, in order")
    whole = p12["b"]["whole"][:P15_STEPS]
    rel = [abs(s[0] / w - 1) for s, w in zip(steps, whole)]
    check(len(steps) == P15_STEPS and all(r <= 2**-8 for r in rel),
          f"15b: losses {[s[0] for s in steps]} leave phase 12b's "
          f"uninterrupted {whole} beyond 2^-8 relative")
    check(all(s[4] == s[5] == cfg.n_layers for s in steps),
          f"15b: F1/F2 launches per step {[s[4:] for s in steps]}, "
          f"expected {cfg.n_layers} each")
    waits = [s[3] for s in steps]
    check(all(w is not None and w > 0 for w in waits),
          f"15b: the step_span's data_wait phase read {waits}")
    walls = [s[2] for s in steps[1:]]
    tps = P12_BATCH * P12_SEQ * len(walls) / sum(walls)
    print(f"  15b: TorchTrainer(datasets={{'train': a {P15_BLOCKS}-block "
          f"Dataset of {len(rows)} rows}}): losses "
          + ", ".join(f"{s[0]:.6f}" for s in steps)
          + f" (phase 12b uninterrupted "
          + ", ".join(f"{w:.6f}" for w in whole)
          + f"; largest relative difference {max(rel):.3e}, limit 2^-8); "
          f"{tps:.1f} tokens/s (steps 2-3; phase 12b "
          f"{p12['b']['tokens_per_s']:.1f}); data_wait per step "
          + ", ".join(f"{w:.4f}" for w in waits)
          + f" s; F1 + F2 per step {steps[0][4]} + {steps[0][5]}; every row "
          f"read once; fit {fit_s:.1f} s")
    ok, free = card_free_again(free0)
    check(ok, f"15b: the card has {free} bytes free after the trainer, "
          f"not {free0}")
    return {"tokens_per_s": tps, "data_wait_s": waits, "max_rel": max(rel),
            "launches": [s[4:] for s in steps], "fit_s": fit_s}


def phase15(seed, p2, p12):
    import ray_tpu_torch as rt

    print("phase 15: Ray Data on the card: llama3_8b batch inference "
          "through a data actor pool, a TorchTrainer fed by a Dataset")
    rt.init(num_cpus=4)
    try:
        check(rt.cluster_resources().get("GPU") == 1.0,
              "the cluster does not have the card's one GPU")
        # Phase 14 left no worker process: what is free now is the card
        # less this process's own use.
        free0 = torch.cuda.mem_get_info()[0]
        a = phase15a(seed, p2, free0)
        b = phase15b(seed, p12, free0)
    finally:
        rt.shutdown()
    return {"a": a, "b": b}


# ------------------------------------------------------------ phase 16
# Tune on the card: Sweeps of TorchTrainer gangs, each one worker on half
# of the card, so two gangs share it at a time.
P16_GPUS = 0.5
P16A_LRS = (3e-4, 1e-4, 3e-5, 1e-5)  # best expected first; 3e-4 is 12b's
P16B_LRS, P16B_MUTATION = (3e-4, 3e-6), 1e-4
P16B_STEPS, P16B_SAVE_AT = 6, 2
P16_POLL_S = 0.2
P16_DEADLINE_S = 300.0  # longest wait of a trial's loop for the sweep


def p16_judged_asha(out, **kw):
    """LedgerASHA that writes each rung decision to ``out/rung-<trial>-<n>``;
    a trial reaching a rung waits for it, so every trial is judged on its
    rung step's loss and a stopped trial stops at the rung."""
    import os as _os

    from ray_tpu_torch.tune import LedgerASHA

    class JudgedASHA(LedgerASHA):
        def decide(self, trial_id, steps, value):
            before = self._judged.get(trial_id, 0)
            decision = super().decide(trial_id, steps, value)
            rung = self._judged.get(trial_id, 0)
            if rung != before:
                path = f"{out}/rung-{trial_id}-{rung}"
                with open(path + ".tmp", "w") as f:
                    f.write(decision)
                _os.replace(path + ".tmp", path)
            return decision

    return JudgedASHA(**kw)


def p16_sweep_class():
    """tune.Sweep that also records each trial launch's time and each
    fork's seconds (the sweep itself is unchanged)."""
    from ray_tpu_torch.tune import Sweep

    class TimedSweep(Sweep):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.launched, self.fork_s = [], []

        def _launch(self, t):
            self.launched.append((t.trial_id, time.time()))
            super()._launch(t)

        def _maybe_fork(self, t):
            forks, t0 = self.forks, time.perf_counter()
            super()._maybe_fork(t)
            if self.forks > forks:
                self.fork_s.append(time.perf_counter() - t0)

    return TimedSweep


def p16_trial_loop(config):
    """One trial: phase 12b's bench state from the seed with its optimizer
    at config["lr"] (no warm-up, config["steps"] total), trained on 12b's
    batches to config["steps"], reporting loss each step. A relaunch after
    a PBT exploit restores the forked checkpoint, holds it bit for bit
    against the winner's (p12_mismatched) and steps once the winner has
    ended (or was itself relaunched from this trial). With config["save_at"] the state is saved through
    AsyncCheckpointer at that step, the step is reported once the save has
    committed and every trial of the sweep has committed it, and the loop
    then waits until the fork is journaled before it goes on. At each of
    config["rungs"] it waits for the ASHA decision, and on STOP for the
    stop. Each step's record (loss, wall, F1, F2, end time; the save's
    stall and persist) goes to out/<trial>.jsonl."""
    import ray_tpu_torch.train as train
    from ray_tpu_torch import checkpoint as dc
    from ray_tpu_torch.train import (
        init_train_state,
        jit_train_step,
        make_optimizer,
        profile,
    )
    from ray_tpu_torch.util import state as rstate

    loop_start = time.time()
    ctx = train.get_context()
    seed, out, deadline = config["seed"], config["out"], config["deadline_s"]

    def wait_for(pred, what):
        end = time.monotonic() + deadline
        while not pred():
            if time.monotonic() > end:
                raise TimeoutError(f"trial {ctx.trial_id} waited {deadline} "
                                   f"s for {what}")
            time.sleep(0.1)

    def sweep_row():
        return rstate.sweep_stats(sweep_id=ctx.sweep_id)["sweeps"][
            ctx.sweep_id]

    def committed(step):
        return all(dc.latest_step(t["job"]) == step
                   for t in sweep_row()["trials"].values())

    def decision(rung):
        path = f"{out}/rung-{ctx.trial_id}-{rung}"
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read()

    cfg, _ = p12_config()
    opt = make_optimizer(lr=config["lr"], warmup=0,
                         total_steps=config["steps"],
                         mu_dtype=torch.bfloat16)
    state = init_train_state(cfg, opt, seed=seed, device="cuda")
    uri = train.get_checkpoint()
    head = {"loop_start": loop_start, "lr": config["lr"], "restored": uri}
    if uri is not None:
        t0 = time.perf_counter()
        state = dc.restore_uri(uri, target=state)
        sync()
        head["restore_s"] = time.perf_counter() - t0
        source = sweep_row()["trials"][ctx.trial_id]["forked_from"]
        fork_step = dc.parse_uri(uri)[1]
        head["source_uri"] = f"ckpt://{ctx.sweep_id}/{source}/{fork_step}"
        head["source"] = source
        head["mismatched"], _ = p12_mismatched(state, head["source_uri"])
        # Step once the source has ended (or was itself relaunched from
        # this trial), so that its later steps meet no relaunched peer.
        wait_for(lambda: sweep_row()["trials"][source]["state"]
                 == "TERMINATED" or sweep_row()["trials"][source].get(
                     "forked_from") == ctx.trial_id,
                 "the fork's source to end")
    path = os.path.join(out, f"{ctx.trial_id}.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps(head) + "\n")
    saver = dc.AsyncCheckpointer() if config.get("save_at") else None
    step = jit_train_step(cfg, opt)
    while state.step < config["steps"]:
        i = int(state.step)
        data = p12_batch(cfg, seed, i)
        reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, data)
        sync()
        rec = {"step": i, "loss": float(m["loss"]),
               "wall": time.perf_counter() - t0}
        _, rec["f1"], rec["f2"] = counts()
        rec["end"] = time.time()
        if saver is not None and state.step == config["save_at"]:
            t0 = time.perf_counter()
            saver.save(state.step, state)
            rec["stall_s"] = time.perf_counter() - t0
            saver.wait()
            rec["persist_s"] = saver.last["persist_s"]
            rec["commit_s"] = time.perf_counter() - t0
            wait_for(lambda: committed(config["save_at"]),
                     "every trial's checkpoint")
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        # The step profiler's boundary (telemetry.finish_step calls it in
        # a step_span loop; report()'s steps here carry the loss the
        # sweep's ledger ranks, and do not): a no-op until the head's
        # profile_capture fan-out arms it.
        profile.step_hook(ctx, rec["wall"])
        train.report({"loss": rec["loss"]})
        if saver is not None and state.step == config["save_at"]:
            wait_for(lambda: sweep_row().get("forks", 0) >= 1, "the fork")
        if state.step in config.get("rungs", ()):
            rung = int(state.step)
            wait_for(lambda: decision(rung) is not None,
                     f"the decision at rung {rung}")
            if decision(rung) == "STOP":
                wait_for(lambda: False, "the stop")


def p16_records(out, trial_id):
    """A trial's records: one list per launch, each a header (its start,
    lr, what it restored) and its steps."""
    launches = []
    with open(os.path.join(out, f"{trial_id}.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "loop_start" in rec:
                launches.append({**rec, "steps": []})
            else:
                launches[-1]["steps"].append(rec)
    return launches


def p16_run(name, space, out, storage, **cfg_kw):
    """One Sweep of p16_trial_loop over ``space``; returns the sweep, its
    result, the journal's row and each trial's records."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.util import state as rstate

    sweep = p16_sweep_class()(
        p16_trial_loop, {**space, "out": out, "deadline_s": P16_DEADLINE_S},
        sweep_id=name, storage_path=storage,
        config=tune.SweepConfig(num_samples=1, workers_per_trial=1,
                                gpus_per_worker=P16_GPUS, max_failures=0,
                                poll_s=P16_POLL_S, **cfg_kw))
    res = sweep.run()
    check(all(t.state == "TERMINATED" and t.error is None
              for t in res.trials),
          f"16 {name}: trials " + ", ".join(
              f"{t.trial_id} {t.state} {t.error}" for t in res.trials))
    row = rstate.sweep_stats(sweep_id=name)["sweeps"][name]
    check(row["state"] == "FINISHED" and len(row["trials"]) == len(res.trials)
          and all(r["state"] == "TERMINATED" for r in row["trials"].values()),
          f"16 {name}: the head's sweep row {row.get('state')} with "
          f"{len(row.get('trials', {}))} trials journaled")
    recs = {t.trial_id: p16_records(out, t.trial_id) for t in res.trials}
    return sweep, res, row, recs


def p16_launch_checks(name, recs, cfg):
    """Every step of every trial launched 24 F1 and 24 F2; returns all
    steps' (F1, F2)."""
    per = [(s["f1"], s["f2"]) for launches in recs.values()
           for launch in launches for s in launch["steps"]]
    check(per and all(p == (cfg.n_layers, cfg.n_layers) for p in per),
          f"16 {name}: F1/F2 launches per step {per}, expected "
          f"{cfg.n_layers} each")
    return per


def p16_readings(name, sweep, res, recs):
    """Per-trial fit set-up seconds (launch to the loop's start) and
    tokens/s (steps after each launch's first), the sweep's makespan and
    idle share; printed."""
    starts = {}
    for tid, ts in sweep.launched:
        starts.setdefault(tid, []).append(ts)
    card = card_line()
    out = {"makespan_s": res.stats["makespan_s"],
           "idle": res.stats["chip_idle_fraction"], "trials": {}}
    for tid, launches in recs.items():
        for n, launch in enumerate(launches):
            walls = [s["wall"] for s in launch["steps"][1:]]
            tps = (P12_BATCH * P12_SEQ * len(walls) / sum(walls)
                   if walls else None)
            setup = launch["loop_start"] - starts[tid][n]
            out["trials"].setdefault(tid, []).append(
                {"setup_s": setup, "tokens_per_s": tps,
                 "steps": len(launch["steps"])})
            print(f"  16{name} {tid} launch {n} (lr {launch['lr']:g}): fit "
                  f"set-up {setup:.2f} s, {len(launch['steps'])} steps, "
                  + (f"{tps:.1f} tokens/s" if tps else "no timed step")
                  + f" [{card}]")
    print(f"  16{name}: makespan {out['makespan_s']:.2f} s, "
          f"chip_idle_fraction {out['idle']} [{card}]")
    return out


def p16_capture_requester(done, got):
    """Once a trial has reported step 1 to the head's train ledger, ask
    the head for a capture of the next step of every rank
    (util.state.profile_capture); returns at once after, or at ``done``."""
    from ray_tpu_torch.util import state as rstate

    end = time.monotonic() + P16_DEADLINE_S
    while not done.is_set() and time.monotonic() < end:
        jobs = rstate.train_stats().get("jobs", {})
        if any((j.get("steps") or 0) >= 1 for j in jobs.values()):
            got["at"] = time.time()
            got["reply"] = rstate.profile_capture(steps=1)
            return
        time.sleep(0.2)


P16_SPAN_KEYS = ("train_job", "train_rank", "train_attempt", "profile_sig",
                 "profile_steps", "profile_step_s", "profile_shares",
                 "profile_dominant", "path")


def p16_capture_checks(got):
    """The profile:step spans the capture sent to the head: at least one,
    with the reference's keys and a measured matmul time above 0; and
    the head's profile ledger holding their jobs."""
    import ray_tpu_torch.api as api
    from ray_tpu_torch.util import state as rstate

    check("reply" in got and got["reply"].get("ok") is True,
          f"16a: profile_capture was not acknowledged: {got}")
    rt = api._runtime
    events = rt.run(rt.core.head.call("list_task_events", limit=20000,
                                      raw=True))["events"]
    spans = [e for e in events if e.get("name") == "profile:step"]
    stats = rstate.profile_stats()["jobs"]
    card = card_line()
    for e in spans:
        print(f"  16a capture {e.get('train_job')}: step "
              f"{e.get('profile_step_s', 0) * 1e3:.1f} ms, measured s "
              f"{e.get('profile_measured_s')}, shares "
              f"{e.get('profile_shares')}, dominant "
              f"{e.get('profile_dominant')} [{card}]")
    check(spans and all(all(k in e for k in P16_SPAN_KEYS) for e in spans),
          f"16a: profile:step spans at the head: {spans}")
    check(any((e.get("profile_measured_s") or {}).get("matmul", 0) > 0
              for e in spans),
          "16a: no captured span measured matmul time")
    check(all(e["train_job"] in stats for e in spans
              if e.get("train_rank") == 0),
          f"16a: profile_stats jobs {sorted(stats)}")
    return {"spans": len(spans), "requested_at": got["at"],
            "measured": [e.get("profile_measured_s") for e in spans]}


def phase16a(seed, p12, plan_kwargs, work):
    """LedgerASHA over 4 learning rates, two gangs at a time; a capture
    requested through the head once a trial has reported step 1."""
    import threading

    cfg, _ = p12_config()
    out = os.path.join(work, "asha")
    os.makedirs(out)
    done, got = threading.Event(), {}
    requester = threading.Thread(target=p16_capture_requester,
                                 args=(done, got), daemon=True)
    requester.start()
    try:
        sweep, res, row, recs = p16_run(
            "phase16a", {"lr": {"grid_search": list(P16A_LRS)},
                         "steps": P12_STEPS, "seed": seed, "rungs": [2, 4]},
            out, os.path.join(work, "results"), plan_kwargs=plan_kwargs,
            scheduler=p16_judged_asha(out, metric="loss", mode="min",
                                      grace_period=2, reduction_factor=2))
    finally:
        done.set()
        requester.join(timeout=30)
    capture = p16_capture_checks(got)
    stopped = sorted(t for t, r in row["trials"].items()
                     if r.get("stop_reason") == "rung")
    ran = {t: len(recs[t][0]["steps"]) for t in recs}
    for t in res.trials:
        print(f"  16a {t.trial_id} lr {t.config['lr']:g}: ledger loss "
              f"{t.ledger.get('loss')}, steps {t.ledger.get('steps')}, "
              + ("stopped at the rung" if t.trial_id in stopped
                 else "ran to the end")
              + ": losses " + ", ".join(
                  f"{s['loss']:.6f}" for s in recs[t.trial_id][0]["steps"]))
    # Every stopped trial stopped at one of its rungs, and at least one
    # before its last step. A trial may also be stopped at the last rung
    # (4), after its last step: when the lr 1e-4 trial is judged first at
    # rung 2 it goes on, and if lr 3e-4 then reaches rung 4 first, 1e-4's
    # worse loss there is stopped.
    check(any(ran[t] < P12_STEPS for t in stopped)
          and all(ran[t] in (2, P12_STEPS) for t in stopped),
          f"16a: ASHA stopped {stopped}, steps run {ran}")
    spans = [(launch["loop_start"], launch["steps"][-1]["end"])
             for launches in recs.values() for launch in launches]
    check(all(sum(1 for a, b in spans if a <= s < b) <= 2
              for s, _ in spans)
          and any(a < s < b for s, _ in spans for a, b in spans),
          f"16a: the trials' loops ran {sorted(spans)}: not two at a time")
    frees = [f for _ts, f, total in sweep.utilization if total > 0]
    check(frees and min(frees) == 0.0 and all(f >= 0 for f in frees),
          f"16a: sampled free GPU {frees}")
    per = p16_launch_checks("a", recs, cfg)
    first = next(t for t in res.trials if t.config["lr"] == P16A_LRS[0])
    losses = [s["loss"] for s in recs[first.trial_id][0]["steps"]]
    whole = p12["b"]["whole"][:len(losses)]
    rel = [abs(a / b - 1) for a, b in zip(losses, whole)]
    print(f"  16a lr {P16A_LRS[0]:g} (phase 12b's config): losses "
          + ", ".join(f"{x:.6f}" for x in losses) + " (12b uninterrupted "
          + ", ".join(f"{x:.6f}" for x in whole)
          + f"; largest relative difference {max(rel):.3e}, limit 2^-8)")
    check(len(losses) >= 2 and max(rel) <= 2**-8,
          "16a: the lr 3e-4 trial's losses leave phase 12b's")
    read = p16_readings("a", sweep, res, recs)
    return {**read, "stopped": stopped, "ran": ran, "max_rel": max(rel),
            "launches": per, "f1": sum(p[0] for p in per),
            "f2": sum(p[1] for p in per), "capture": capture}


def phase16b(seed, work):
    """LedgerPBT over 2 learning rates: an exploit forks the winner's
    shard-store checkpoint into the loser's run."""
    from ray_tpu_torch import checkpoint as dc
    from ray_tpu_torch import tune

    cfg, _ = p12_config()
    out = os.path.join(work, "pbt")
    os.makedirs(out)
    sweep, res, row, recs = p16_run(
        "phase16b", {"lr": {"grid_search": list(P16B_LRS)},
                     "steps": P16B_STEPS, "seed": seed,
                     "save_at": P16B_SAVE_AT},
        out, os.path.join(work, "results"),
        pbt=tune.LedgerPBT(metric="loss", mode="min",
                           perturbation_interval=P16B_SAVE_AT,
                           hyperparam_mutations={"lr": [P16B_MUTATION]},
                           quantile_fraction=0.5, seed=seed))
    check(res.stats["forks"] >= 1, f"16b: {res.stats['forks']} forks")
    # Every relaunch, in order: (trial, launch record).
    relaunches = sorted(((tid, launch) for tid, launches in recs.items()
                         for launch in launches[1:]),
                        key=lambda r: r[1]["loop_start"])
    check(len(relaunches) == res.stats["forks"],
          f"16b: {len(relaunches)} relaunches for {res.stats['forks']} forks")
    loser_id, first = relaunches[0]
    winner_id = first["source"]
    jrec = row["trials"][loser_id]
    check(jrec.get("forked_from") is not None
          and jrec.get("fork_step") == P16B_SAVE_AT,
          f"16b: the journal's lineage {jrec.get('forked_from')} at "
          f"{jrec.get('fork_step')}")
    share = dc.fork_shares_chunks(f"phase16b/{winner_id}",
                                  f"phase16b/{loser_id}", P16B_SAVE_AT)
    check(share["new_chunks"] == 0 and share["dedup_ratio"] == 1.0
          and share["dst_chunks"] > 0, f"16b: the fork's chunks {share}")
    won = {s["step"]: s["loss"] for s in recs[winner_id][0]["steps"]}
    want = won.get(P16B_SAVE_AT)
    diffs = []
    for tid, launch in relaunches:
        check(launch["restored"] == f"ckpt://phase16b/{tid}/{P16B_SAVE_AT}"
              and launch["lr"] == P16B_MUTATION
              and launch["mismatched"] == 0,
              f"16b: {tid} relaunched from {launch['restored']} at lr "
              f"{launch['lr']}, {launch['mismatched']} leaves differ from "
              f"{launch['source_uri']}")
        check(launch["steps"], f"16b: {tid}'s relaunch ran no step")
        got = launch["steps"][0]
        check(got["step"] == P16B_SAVE_AT and want is not None,
              f"16b: {tid}'s relaunch began at step {got['step']}; the "
              f"winner's loss there {want}")
        diffs.append(abs(got["loss"] / want - 1))
    check(max(diffs) <= 1e-5, f"16b: the first losses after the restores "
          f"leave the winner's {want} by {diffs} relative (limit 1e-5)")
    for tid, launches in recs.items():
        check([s["step"] for s in launches[-1]["steps"]][-1:]
              == [P16B_STEPS - 1],
              f"16b: {tid}'s last launch ended at "
              f"{[s['step'] for s in launches[-1]['steps']]}")
    check(res.trials[[t.trial_id for t in res.trials].index(loser_id)]
          .config["lr"] == P16B_MUTATION, "16b: the loser's final lr")
    print(f"  16b: {loser_id} (lr {recs[loser_id][0]['lr']:g}) exploited "
          f"by {winner_id} (lr {recs[winner_id][0]['lr']:g}); "
          f"{res.stats['forks']} fork(s); the first of step {P16B_SAVE_AT}:"
          f" {share['dst_chunks']} chunks, {share['new_chunks']} new, dedup "
          f"ratio {share['dedup_ratio']}; relaunched at lr "
          f"{first['lr']:g}, restored state bit for bit the winner's "
          f"checkpoint; first loss after the restore "
          f"{first['steps'][0]['loss']:.6f} at step {P16B_SAVE_AT}, the "
          f"winner's {want:.6f} (relative difference {diffs[0]:.3e}, "
          f"limit 1e-5)")
    per = p16_launch_checks("b", recs, cfg)
    card = card_line()
    saves = [s for launches in recs.values() for s in launches[0]["steps"]
             if "stall_s" in s]
    for s in saves:
        print(f"  16b save at step {P16B_SAVE_AT}: save() stalled the loop "
              f"{s['stall_s']:.3f} s, persist {s['persist_s']:.2f} s, "
              f"committed {s['commit_s']:.2f} s after save() [{card}]")
    relaunched = [ts for tid, ts in sweep.launched if tid == loser_id][1]
    to_step = first["steps"][0]["end"] - relaunched
    print(f"  16b: the fork took {sweep.fork_s[0]:.3f} s; relaunch to the "
          f"first restored step {to_step:.2f} s (restore "
          f"{first['restore_s']:.2f} s) [{card}]")
    read = p16_readings("b", sweep, res, recs)
    return {**read, "forks": res.stats["forks"], "share": share,
            "diff": max(diffs), "fork_s": sweep.fork_s[0],
            "to_step_s": to_step, "restore_s": first["restore_s"],
            "saves": [(s["stall_s"], s["persist_s"]) for s in saves],
            "launches": per, "f1": sum(p[0] for p in per),
            "f2": sum(p[1] for p in per)}


def phase16(seed, p12):
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import admission

    print("phase 16: Tune on the card: Sweeps of TorchTrainer gangs on "
          "half-GPU leases (LedgerASHA, then a checkpoint-forked LedgerPBT "
          "exploit)")
    cfg, _ = p12_config()
    rt.init(num_cpus=8, _system_config={"POOL_BYTES": P12_POOL_BYTES})
    try:
        check(rt.cluster_resources().get("GPU") == 1.0,
              "the cluster does not have the card's one GPU")
        free0 = torch.cuda.mem_get_info()[0]
        plan_kwargs = {"cfg": cfg, "batch": P12_BATCH, "seq": P12_SEQ,
                       "mu_dtype": "bfloat16"}
        ticket = admission.admit_gang(1, P16_GPUS, plan_kwargs=plan_kwargs)
        plan = ticket.plan
        print(f"  16 admission ticket for one trial: {ticket.reason}; plan "
              f"{plan.total_gb:.2f} GiB of {plan.usable_bytes / 2**30:.2f} "
              f"GiB usable (remat {cfg.remat} priced as the planner prices "
              f"it), fits {plan.fits}; {ticket.free_chips:g} of "
              f"{ticket.total_chips:g} GPU free")
        if not plan.fits:
            print("  16: the planner rejects the trial's config: the sweeps "
                  "run without plan_kwargs")
            plan_kwargs = None
        with tempfile.TemporaryDirectory(prefix="chip_smoke_p16_") as work:
            a = phase16a(seed, p12, plan_kwargs, work)
            b = phase16b(seed, work)
        ok, free1 = card_free_again(free0)
        check(ok, f"16: the card has {free1} bytes free after the sweeps, "
              f"not {free0}")
        print(f"  16: card free {free0 / 2**30:.2f} GiB before the sweeps, "
              f"{free1 / 2**30:.2f} GiB after")
    finally:
        rt.shutdown()
    return {"a": a, "b": b}


# ------------------------------------------------------------ phase 17
# The JAX package's test configurations: tests/test_rl.py's PPO,
# tests/test_rl_appo_connectors.py's APPO and its target-refresh case.
P17_PPO = dict(env="Chain", env_kwargs={"n": 6}, num_env_runners=2,
               num_envs_per_runner=4, rollout_len=32, hidden=(32,),
               lr=3e-3, seed=0)
P17_PPO_ITERS = 15
P17_APPO = dict(P17_PPO, target_update_freq=4)
P17_APPO_ITERS = 80
P17_REFRESH = dict(env="Chain", env_kwargs={"n": 4}, num_env_runners=1,
                   num_envs_per_runner=2, rollout_len=8, hidden=(8,),
                   target_update_freq=1000, updates_per_rollout=1, seed=0)
P17_REL = 1e-5


class P17Meter:
    """Wraps an algorithm's learner update and runner sampling: the ms of
    each (a learner update ends in a host read of its metrics, so its
    clock covers the card's work), and the first update's batch, weights
    and results."""

    def __init__(self, algo):
        self.update_ms, self.sample_ms, self.first = [], [], None
        learner, runners = algo.learner, algo.runners
        update, sample = learner.update, runners.sample

        def timed_update(batch, *extra):
            before = learner.get_weights() if self.first is None else None
            t0 = time.perf_counter()
            out = update(batch, *extra)
            self.update_ms.append((time.perf_counter() - t0) * 1e3)
            if before is not None:
                self.first = {"batch": dict(batch), "before": before,
                              "out": out, "after": learner.get_weights()}
            return out

        def timed_sample(*a, **k):
            t0 = time.perf_counter()
            out = sample(*a, **k)
            self.sample_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        learner.update, runners.sample = timed_update, timed_sample


def p17_redo_on_cpu(algo, first):
    """The first learner update again through the port on the CPU (TF32
    is off in this process): the same loss, optimizer, batch and
    weights."""
    from ray_tpu_torch.rl.learner import Learner
    from ray_tpu_torch.rl.module import tree_leaves

    learner = algo.learner
    cpu = Learner(algo.module, learner.loss_fn, learner.optimizer,
                  device="cpu")
    cpu.set_weights(first["before"])
    cpu.opt_state = cpu.optimizer.init(cpu.params)
    out = cpu.update(first["batch"])
    worst = {}
    for k in ("loss", "grad_norm"):
        worst[k] = abs(out[k] - first["out"][k]) / abs(out[k])
    got = tree_leaves(first["after"])
    for i, (a, b) in enumerate(zip(got, tree_leaves(cpu.params))):
        b = b.numpy()
        worst[f"leaf {i}"] = float(np.abs(a - b).max()
                                   / max(np.abs(b).max(), 1e-30))
    return worst


def p17_summary(label, meter, iters, steps, wall):
    """Prints the update and sample ms and env steps/s; every update's and
    every iteration's ms go to OUT_DIR/p17<label>.json."""
    ms = np.array(meter.update_ms)
    card = card_line()
    path = os.path.join(OUT_DIR, f"p17{label}.json")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"card": card, "update_ms": meter.update_ms,
                   "sample_ms": meter.sample_ms}, f)
    print(f"  17{label}: {len(ms)} learner updates, ms min {ms.min():.3f} "
          f"median {np.median(ms):.3f} max {ms.max():.3f} (each in {path}); "
          f"sample ms per iteration median {np.median(meter.sample_ms):.2f} "
          f"over {len(meter.sample_ms)}; {steps} env steps in {wall:.2f} s "
          f"of {iters} iterations, {steps / wall:.1f} env steps/s [{card}]")
    return {"update_ms": [float(x) for x in ms],
            "update_ms_median": float(np.median(ms)),
            "sample_ms_median": float(np.median(meter.sample_ms)),
            "env_steps_per_s": steps / wall, "wall_s": wall}


def phase17a(algo):
    """PPO on the chain, the learner on cuda."""
    from ray_tpu_torch.rl.module import tree_leaves

    try:
        meter = P17Meter(algo)
        t0, steps = time.perf_counter(), 0
        for _ in range(P17_PPO_ITERS):
            result = algo.train()
            steps += result["num_env_steps_sampled"]
        wall = time.perf_counter() - t0
        obs = np.zeros((1, 6), np.float32)
        obs[0, 0] = 1.0
        action = int(algo.compute_actions(obs)[0])
        devices = {str(t.device) for t in tree_leaves(algo.learner.params)}
        worst = p17_redo_on_cpu(algo, meter.first)
    finally:
        algo.stop()
    key = max(worst, key=worst.get)
    print(f"  17a PPO: mean return {result['episode_return_mean']:.3f} after "
          f"{result['training_iteration']} iterations, loss "
          f"{result['loss']:.6f}, greedy action at the start {action}, "
          f"params on {sorted(devices)}; first update again on the CPU: "
          f"loss {meter.first['out']['loss']:.8f}, grad_norm "
          f"{meter.first['out']['grad_norm']:.8f}, worst relative "
          f"difference {key} {worst[key]:.3e} (limit {P17_REL:g})")
    check(result["episode_return_mean"] > 0.5
          and result["training_iteration"] == P17_PPO_ITERS,
          f"17a: PPO mean return {result['episode_return_mean']}")
    check(devices == {"cuda:0"}, f"17a: learner params on {devices}")
    check(action == 1, f"17a: greedy action at the start {action}")
    check(all(np.isfinite(v) and v <= P17_REL for v in worst.values()),
          f"17a: the CPU update differs: {worst}")
    return {**p17_summary("a", meter, P17_PPO_ITERS, steps, wall),
            "return": result["episode_return_mean"],
            "worst_rel": worst[key], "worst_key": key}


def phase17b(algo, refresh):
    """APPO on the chain (asynchronous sampling), then the target
    network's refresh on ``refresh`` (its test's configuration)."""
    from ray_tpu_torch.rl.module import tree_leaves

    try:
        meter = P17Meter(algo)
        t0, steps, losses = time.perf_counter(), 0, []
        for _ in range(P17_APPO_ITERS):
            # Sampling is asynchronous here (IMPALA's loop waits for the
            # first of the runners' in-flight rollouts): an iteration's
            # sample ms is its wall less its learner updates.
            t_it, n0 = time.perf_counter(), len(meter.update_ms)
            result = algo.train()
            meter.sample_ms.append((time.perf_counter() - t_it) * 1e3
                                   - sum(meter.update_ms[n0:]))
            steps += result["num_env_steps_sampled"]
            losses.append(result["loss"])
        wall = time.perf_counter() - t0
        obs = np.zeros((1, 6), np.float32)
        obs[0, 0] = 1.0
        action = int(algo.compute_actions(obs)[0])
    finally:
        algo.stop()
    print(f"  17b APPO: mean return {result['episode_return_mean']:.3f} after "
          f"{P17_APPO_ITERS} iterations, loss {losses[-1]:.6f}, greedy action "
          f"at the start {action}")
    check(all(np.isfinite(losses)), "17b: an APPO loss is not finite")
    check(result["episode_return_mean"] > 0.5,
          f"17b: APPO mean return {result['episode_return_mean']}")
    check(action == 1, f"17b: greedy action at the start {action}")
    read = p17_summary("b", meter, P17_APPO_ITERS, steps, wall)

    algo = refresh
    try:
        before = tree_leaves(algo.target_params)[0].clone()
        algo.train()
        frozen = torch.equal(before, tree_leaves(algo.target_params)[0])
        moved = not torch.equal(before, tree_leaves(algo.learner.params)[0])
        algo._updates_since_target = 999  # the next update crosses freq
        algo.train()
        refreshed = all(
            torch.equal(t, o) for t, o in zip(
                tree_leaves(algo.target_params),
                tree_leaves(algo.learner.params)))
        on = {str(t.device) for t in tree_leaves(algo.target_params)}
    finally:
        algo.stop()
    print(f"  17b target network: frozen over an iteration {frozen} (online "
          f"moved {moved}), equal to the online params after the refresh "
          f"{refreshed}, on {sorted(on)}")
    check(frozen and moved and refreshed and on == {"cuda:0"},
          "17b: the APPO target network's refresh")
    return {**read, "return": result["episode_return_mean"],
            "loss": losses[-1]}


def phase17(during=None):
    """17a-b, then 17c's fit, with ``during()`` called while it runs
    (its result under "during")."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rl import APPOConfig, PPOConfig

    print("phase 17: RL on the runtime, the learner on the card, 2 CPU "
          "env-runner actors (PPO, then APPO)")
    t0 = time.perf_counter()
    rt.init(num_cpus=8)
    try:
        # The three algorithms' env-runner actors (2 + 2 + 1) start at
        # once: each build waits for its actors' processes, which spend
        # seconds importing torch. (rt.shutdown ends them all.)
        configs = (PPOConfig(**P17_PPO, device="cuda"),
                   APPOConfig(**P17_APPO, device="cuda"),
                   APPOConfig(**P17_REFRESH, device="cuda"))
        with concurrent.futures.ThreadPoolExecutor(len(configs)) as pool:
            futures = [pool.submit(c.build) for c in configs]
        algos = [f.result() for f in futures]
        print(f"  17: PPO, APPO and the refresh case's APPO built together "
              f"(learners on the card, 5 env-runner actors) in "
              f"{time.perf_counter() - t0:.2f} s")
        a = phase17a(algos[0])
        b = phase17b(algos[1], algos[2])
        s = time.perf_counter() - t0
        c = phase17c(during)
    finally:
        rt.shutdown()
    return {"a": a, "b": b, "c": c, "s": s}


# ------------------------------------------------------------ phase 17c
# The composed pp x ep x fsdp loop (parallel/showcase.py) through
# TorchTrainer, as the JAX package's dry run drives it through JaxTrainer.
P17C_STEPS = 2
P17C_REL = 1e-5


def p17c_fit(name, scaling, config, work):
    from ray_tpu_torch.parallel.showcase import composed_trainer_loop
    from ray_tpu_torch.train import RunConfig, TorchTrainer

    t0 = time.perf_counter()
    result = TorchTrainer(
        composed_trainer_loop, train_loop_config=config,
        scaling_config=scaling,
        run_config=RunConfig(name=name, storage_path=work)).fit()
    return result, time.perf_counter() - t0


def p17c_saved(work, name):
    """Every step's rank-0 params.npz of a fit, in step order."""
    out = []
    for path in sorted(glob.glob(os.path.join(work, name, "*",
                                              "params.npz"))):
        with np.load(path) as z:
            out.append({k: z[k] for k in z.files})
    return out


def p17c_plain(init, steps):
    """The composed program's arithmetic in one process on the CPU, no
    mesh (fp32): two stages of the dense block and the masked sum over
    every expert on the batch of ones, the loss mean(y ** 2), then
    ``p - 0.1 g``. Per step: (loss, gradient norm, params after)."""
    from ray_tpu_torch.parallel.showcase import D, N_EXPERTS, PP

    p = {k: torch.tensor(v, dtype=torch.float32) for k, v in init.items()}
    out = []
    for _ in range(steps):
        e = p["experts"].detach().requires_grad_(True)
        d = p["dense"].detach().requires_grad_(True)
        x = torch.ones((4, D))  # composed_value_and_grad's batch at fsdp 1
        for s in range(PP):
            x = x + torch.tanh(x @ d[s])
            outs = torch.einsum("md,edh->emh", x, e[s])
            assigned = (x[:, 0].abs() * 100).to(torch.int32) % N_EXPERTS
            mask = assigned[None, :] == torch.arange(N_EXPERTS)[:, None]
            x = x + torch.tanh(torch.sum(outs * mask[..., None], dim=0))
        loss = torch.mean(x ** 2)
        ge, gd = torch.autograd.grad(loss, [e, d])
        p = {"experts": e.detach() - 0.1 * ge,
             "dense": d.detach() - 0.1 * gd}
        out.append((float(loss.detach()),
                    float(torch.sqrt(torch.sum(ge * ge) + torch.sum(gd * gd))),
                    {k: v.numpy() for k, v in p.items()}))
    return out


def phase17c(during=None):
    """composed_trainer_loop on 4 workers of 0.25 GPU over gloo (the
    {pp: 2, ep: 2, fsdp: 1} mesh, bucketed overlap sync), held to the
    program's plain arithmetic on the CPU from the same parameters
    (p17c_plain); ``during()`` runs meanwhile (the fit's time is its
    workers' start)."""
    from ray_tpu_torch.parallel.showcase import make_composed_params
    from ray_tpu_torch.train import ScalingConfig
    from ray_tpu_torch.util import state

    work = os.path.abspath(os.path.join(OUT_DIR, "p17c"))
    shutil.rmtree(work, ignore_errors=True)  # each step's params.npz below
    init = {k: v.numpy() for k, v in make_composed_params(
        torch.Generator().manual_seed(7), "cpu").items()}
    scaling = ScalingConfig(num_workers=4, use_gpu=True, gpus_per_worker=0.25,
                            grad_overlap=True, grad_bucket_mb=0.001,
                            distributed=True, dist_backend="gloo")
    # 17a-b's actors give their CPUs back a moment after they end.
    deadline = time.monotonic() + 30
    while sum(n["available"].get("CPU", 0) for n in state.list_nodes()) < 4 \
            and time.monotonic() < deadline:
        time.sleep(0.2)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(
            p17c_fit, "p17c_gpu", scaling,
            {"fsdp": 1, "steps": P17C_STEPS, "device": "cuda",
             "params": init}, work)
        want = p17c_plain(init, P17C_STEPS)
        during_out = during() if during is not None else None
    res, fit_s = future.result()
    check(res.error is None, f"17c: the fit failed: {res.error}")
    check(res.checkpoint is not None and os.path.exists(
        os.path.join(res.checkpoint, "params.npz")),
        "17c: the fit persisted no params.npz")
    got = res.metrics
    check(got.get("grad_buckets", 0) >= 2 and math.isfinite(got["loss"])
          and got["step"] == P17C_STEPS - 1, f"17c: metrics {got}")
    job, deadline = {}, time.time() + 15
    while time.time() < deadline:
        job = state.train_stats().get("jobs", {}).get("p17c_gpu", {})
        if job.get("comm_exposed_s", 0) > 0:
            break
        time.sleep(0.3)
    check(job.get("comm_exposed_s", 0) > 0,
          f"17c: the train ledger shows no exposed comm: {job}")
    loss, norm, _ = want[-1]
    worst = {"loss": abs(got["loss"] - loss) / abs(loss),
             "grad_norm": abs(got["grad_norm"] - norm) / abs(norm)}
    saved = p17c_saved(work, "p17c_gpu")
    check(len(saved) == P17C_STEPS, f"17c: {len(saved)} saved steps")
    for i, (g, (_, _, w)) in enumerate(zip(saved, want)):
        check(sorted(g) == sorted(w), f"17c: saved leaves {sorted(g)}")
        for k in w:
            worst[f"step {i} {k}"] = float(
                np.abs(g[k] - w[k]).max() / np.abs(w[k]).max())
    key = max(worst, key=worst.get)
    print(f"  17c composed loop: 4 GPU workers (0.25 each, gloo) fit "
          f"{fit_s:.2f} s; loss {got['loss']:.8f} (plain CPU {loss:.8f}), "
          f"grad_norm {got['grad_norm']:.8f}, {got['grad_buckets']} buckets, "
          f"comm exposed {job['comm_exposed_s']:.4f} s; worst relative "
          f"difference to the plain CPU steps {key} {worst[key]:.3e} (limit "
          f"{P17C_REL:g}) [{card_line()}]")
    check(all(v <= P17C_REL for v in worst.values()),
          f"17c: the GPU fit differs from the plain CPU steps: {worst}")
    return {"during": during_out, "fit_s": fit_s, "loss": got["loss"],
            "worst_rel": worst[key], "comm_exposed_s": job["comm_exposed_s"]}


# ------------------------------------------------------------ phase 18
# ResNet (models/resnet.py): resnet18 at its published widths on the JAX
# package's synthetic recipe (tests/test_resnet.py) at 32 x 32, and
# resnet50's forward at 224 x 224.
P18_BATCH, P18_HW, P18_STEPS, P18_LR = 256, 32, 30, 1e-3
P18_TIMED = (10, 30)  # images/s over these steps
# bf16 convolutions against the same step in fp32 (CPU): the loss by
# relative difference, the whole gradient by ||got - want|| / ||want||,
# and each leaf by its own such reading, held to P18_LEAF_K times what
# the CPU's own bf16 step reads on that leaf from the same weights and
# batch in the same run. At the initial weights the gradient is small
# and rounding heavy, most in the GroupNorm biases (to ~0.19 of their
# norms on both devices), and the card's reading of a leaf stays near the
# CPU's.
P18_LOSS_REL = 3e-4
P18_GRAD_REL = 6e-2
P18_LEAF_K = 3.0


def p18_synthetic(n, hw, classes=10, seed=0):
    """tests/test_resnet.py's set: noise plus a bright row at a
    label-dependent position."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    images = rng.normal(0, 0.1, (n, hw, hw, 3)).astype(np.float32)
    images[np.arange(n), labels % hw, :, :] += 2.0
    return {"images": torch.from_numpy(images),
            "labels": torch.from_numpy(labels)}


def p18_leaves(tree):
    """The leaves in p18_map's order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in p18_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in p18_leaves(v)]
    return [tree]


def p18_map(tree, fn):
    if isinstance(tree, dict):
        return {k: p18_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [p18_map(v, fn) for v in tree]
    return fn(tree)


def p18_step(params, batch, cfg):
    """The loss and every leaf's gradient (p18_leaves order)."""
    from ray_tpu_torch.models.resnet import loss_fn

    leaves = [t.detach().requires_grad_(True) for t in p18_leaves(params)]
    tree = iter(leaves)
    loss, aux = loss_fn(p18_map(params, lambda _: next(tree)), batch, cfg)
    return loss, torch.autograd.grad(loss, leaves), aux


def p18_classes(params):
    """Each leaf's class, in p18_leaves order."""
    from ray_tpu_torch.models.resnet import CONV_LEAVES, _map

    names = {"scale": "GroupNorm scale", "bias": "GroupNorm bias",
             "w": "head weight", "b": "head bias"}
    return p18_leaves(_map(
        lambda name, _: "conv" if name in CONV_LEAVES else names[name],
        params))


def p18_rel(grads, want):
    """Each leaf's ||g - want|| / ||want||, and the whole gradient's."""
    diff = [g.float().cpu() - w for g, w in zip(grads, want)]
    leaf = [float(d.norm() / w.norm()) for d, w in zip(diff, want)]
    whole = float(torch.cat([d.reshape(-1) for d in diff]).norm()
                  / torch.cat([w.reshape(-1) for w in want]).norm())
    return leaf, whole


def phase18(seed):
    from ray_tpu_torch.models.resnet import PRESETS, forward, init_params

    print("phase 18: ResNet, resnet18 on 32 x 32 synthetic images, "
          "resnet50's forward at 224 x 224")
    t0 = time.perf_counter()
    cfg = PRESETS["resnet18"]
    params = init_params(torch.Generator("cuda").manual_seed(seed), cfg,
                         "cuda")
    host = p18_synthetic(P18_BATCH, P18_HW, seed=seed)
    batch = {k: v.cuda() for k, v in host.items()}
    loss, grads, _ = p18_step(params, batch, cfg)
    cpu_params = p18_map(params, lambda t: t.detach().cpu())
    t1 = time.perf_counter()
    want_loss, want, _ = p18_step(
        cpu_params, host, dataclasses.replace(cfg, dtype=torch.float32))
    t2 = time.perf_counter()
    cpu_loss, cpu_grads, _ = p18_step(cpu_params, host, cfg)
    cpu_s = (t2 - t1, time.perf_counter() - t2)
    loss, want_loss = float(loss.detach()), float(want_loss.detach())
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    cpu_loss_rel = (abs(float(cpu_loss.detach()) - want_loss)
                    / abs(want_loss))
    leaf_rel, grad_rel = p18_rel(grads, want)
    cpu_leaf_rel, cpu_grad_rel = p18_rel(cpu_grads, want)
    classes = p18_classes(params)
    limits = [P18_LEAF_K * r for r in cpu_leaf_rel]
    over = [(i, classes[i], leaf_rel[i], limits[i])
            for i in range(len(limits)) if leaf_rel[i] > limits[i]]
    ratio = [r / c for r, c in zip(leaf_rel, cpu_leaf_rel)]
    first_s = time.perf_counter() - t0
    print(f"  18 resnet18 ({cfg.num_params() / 1e6:.2f} M parameters) B="
          f"{P18_BATCH} bf16 convolutions, first step against fp32 on the "
          f"CPU ({cpu_s[0]:.2f} s; the CPU's bf16 step {cpu_s[1]:.2f} s): "
          f"loss {loss:.6f} vs {want_loss:.6f} (relative {loss_rel:.3e}, "
          f"limit {P18_LOSS_REL:g}; the CPU's bf16 {cpu_loss_rel:.3e}), "
          f"gradient {grad_rel:.3e} of its norm (limit {P18_GRAD_REL:g}; "
          f"the CPU's bf16 {cpu_grad_rel:.3e})")
    for c in sorted(set(classes)):
        idx = [i for i, k in enumerate(classes) if k == c]
        worst = max(idx, key=lambda i: ratio[i])
        print(f"  18 {c} ({len(idx)} leaves): card max "
              f"{max(leaf_rel[i] for i in idx):.3e}, the CPU's bf16 max "
              f"{max(cpu_leaf_rel[i] for i in idx):.3e}; card / CPU "
              f"{min(ratio[i] for i in idx):.3f}-{ratio[worst]:.3f} (limit "
              f"{P18_LEAF_K:g}; the highest leaf {worst})")
    check(loss_rel <= P18_LOSS_REL, f"18: bf16 loss {loss_rel:.3e} off")
    check(grad_rel <= P18_GRAD_REL, f"18: bf16 gradients {grad_rel:.3e} off")
    check(not over, f"18: bf16 gradient leaves past {P18_LEAF_K:g} x the "
          f"CPU's bf16 reading (index, class, reading, limit): {over}")

    leaves = [t.requires_grad_(True) for t in p18_leaves(params)]
    opt = torch.optim.Adam(leaves, lr=P18_LR)
    from ray_tpu_torch.models.resnet import loss_fn

    losses, marks = [], {}
    for i in range(P18_STEPS + 1):
        if i in P18_TIMED:
            sync()
            marks[i] = time.perf_counter()
        if i == P18_STEPS:
            break
        opt.zero_grad(set_to_none=True)
        step_loss, aux = loss_fn(params, batch, cfg)
        step_loss.backward()
        opt.step()
        losses.append(step_loss.detach())
    losses = [float(x) for x in losses]
    lo, hi = P18_TIMED
    step_ms = (marks[hi] - marks[lo]) / (hi - lo) * 1e3
    images_s = P18_BATCH / step_ms * 1e3
    print(f"  18 {P18_STEPS} Adam steps (lr {P18_LR:g}): loss {losses[0]:.4f}"
          f" -> {losses[-1]:.4f}, accuracy {float(aux['accuracy']):.3f}; "
          f"steps {lo}-{hi}: {step_ms:.2f} ms per step, {images_s:.1f} "
          f"images/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{card_line()}]")
    check(all(math.isfinite(x) for x in losses), "18: a loss is not finite")
    check(losses[-1] < losses[0] * 0.5,
          f"18: resnet18 did not learn: {losses[0]} -> {losses[-1]}")
    del params, leaves, opt, grads, batch
    gc.collect()
    torch.cuda.empty_cache()

    r50 = PRESETS["resnet50"]
    params = init_params(torch.Generator("cuda").manual_seed(seed), r50,
                         "cuda")
    images = torch.randn((8, 224, 224, 3),
                         generator=torch.Generator("cuda").manual_seed(seed),
                         device="cuda")
    with torch.no_grad():
        forward(params, images, r50)
        sync()
        t1 = time.perf_counter()
        logits = forward(params, images, r50)
        sync()
        r50_ms = (time.perf_counter() - t1) * 1e3
    print(f"  18 resnet50 ({r50.num_params() / 1e6:.2f} M parameters) "
          f"forward, B=8 at 224 x 224: logits {tuple(logits.shape)} "
          f"{logits.dtype}, {r50_ms:.2f} ms (second call) [{card_line()}]")
    check(tuple(logits.shape) == (8, 1000) and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          "18: resnet50's logits are not finite [8, 1000] fp32")
    del params, images, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss_rel": loss_rel, "grad_rel": grad_rel,
            "cpu_grad_rel": cpu_grad_rel, "leaf_ratio": max(ratio),
            "leaf_rel": leaf_rel, "cpu_leaf_rel": cpu_leaf_rel,
            "classes": classes, "cpu_s": cpu_s, "losses": losses,
            "step_ms": step_ms, "images_s": images_s, "r50_ms": r50_ms,
            "first_s": first_s, "s": time.perf_counter() - t0}


# ------------------------------------------------------------ phase 19
# The port's own cluster: started by its CLI, a job serving mini on the
# card through the job API, then stopped.
P19_DIR = os.path.join(OUT_DIR, "p19")
P19_JOB = """\
import json, os, sys
sys.path.insert(0, {repo!r})
import ray_tpu_torch as rt

spec = json.load(open({spec!r}))
rt.init(address=os.environ["RAY_TPU_ADDRESS"])


@rt.remote(num_gpus=1)
def serve_mini(spec):
    import torch
    from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import PRESETS, init_params
    from ray_tpu_torch.ops.paged_attention import paged_attention

    cfg = PRESETS["mini"]
    params = init_params(cfg, spec["seed"], device="cuda", dtype=cfg.dtype)
    eng = LLMEngine(cfg, max_batch=8, max_seq=2048, params=params,
                    kv="paged", page_size=64, seed=spec["seed"],
                    device="cuda")
    sampling = SamplingParams(max_tokens=spec["max_tokens"])
    order = {{eng.add_request(p, sampling): i
              for i, p in enumerate(spec["prompts"])}}
    outs = [None] * len(order)
    paged_attention.launches = 0
    while eng.has_unfinished():
        for fin in eng.step():
            outs[order[fin["request_id"]]] = fin["tokens"]
    torch.cuda.synchronize()
    return {{"streams": outs, "p1": paged_attention.launches,
             "steps": eng.stats()["decode_steps"], "pid": os.getpid()}}


out = rt.get(serve_mini.remote(spec))
json.dump(out, open({result!r}, "w"))
print("job served", len(out["streams"]), "streams,", out["p1"], "P1 launches")


def p19_serve_mini(prompts, max_tokens, seed):
    # Called by the C++ driver: msgpack data in and out. The worker this
    # runs in holds a CPU lease, so the card is leased by the task.
    got = rt.get(serve_mini.remote(
        {{"prompts": prompts, "max_tokens": max_tokens, "seed": seed}}))
    return {{"streams": got["streams"], "p1": got["p1"],
             "steps": got["steps"]}}


from ray_tpu_torch._private.xlang import register_function

print("registered", register_function("p19_serve_mini", p19_serve_mini))
"""

# Phase 19's C++ driver: the port's C++ client only (raytpu::Driver), no
# Python runtime. Usage: p19_driver <head host:port> <token> <spec file>;
# the spec file holds "<seed> <max_tokens>", then one prompt's token ids
# per line.
P19_CPP_DIR = os.path.join(OUT_DIR, "p19_cpp")
P19_DRIVER = r"""
#include <chrono>
#include <csignal>
#include <fstream>
#include <iostream>
#include <sstream>

#include "raytpu/client.h"

using raytpu::Driver;
using raytpu::Value;
using raytpu::ValueVec;

int main(int argc, char** argv) {
  std::signal(SIGPIPE, SIG_IGN);
  auto t0 = std::chrono::steady_clock::now();
  if (argc != 4) {
    std::cerr << "usage: p19_driver <head host:port> <token> <spec>\n";
    return 2;
  }
  std::ifstream spec(argv[3]);
  int64_t seed = 0, max_tokens = 0;
  spec >> seed >> max_tokens;
  std::string line;
  std::getline(spec, line);
  ValueVec prompts;
  while (std::getline(spec, line)) {
    std::istringstream ids(line);
    ValueVec prompt;
    int64_t id;
    while (ids >> id) prompt.push_back(Value::I(id));
    if (!prompt.empty()) prompts.push_back(Value::A(std::move(prompt)));
  }
  try {
    Driver drv(argv[1], argv[2]);
    std::string blob;
    bool registered = drv.head().KvGet("xfn:p19_serve_mini", &blob);
    std::cout << "REGISTERED " << registered << " " << blob.size() << "\n";
    Value out = drv.Call("p19_serve_mini",
                         {Value::A(std::move(prompts)), Value::I(max_tokens),
                          Value::I(seed)});
    const Value& streams = out.at("streams");
    if (!streams.arr) throw std::runtime_error("no streams in the reply");
    for (size_t k = 0; k < streams.arr->size(); ++k) {
      std::cout << "STREAM " << k;
      for (const Value& t : *(*streams.arr)[k].arr) std::cout << " " << t.i;
      std::cout << "\n";
    }
    std::chrono::duration<double> call_s =
        std::chrono::steady_clock::now() - t0;
    std::cout << "P1 " << out.at("p1").i << "\n"
              << "STEPS " << out.at("steps").i << "\n"
              << "CALL_S " << call_s.count() << "\n";
    try {
      drv.Call("p19_never_registered", {});
      std::cout << "ERROR an unregistered name returned\n";
      return 1;
    } catch (const std::exception& e) {
      std::cout << "RAISED " << e.what() << "\n";
    }
  } catch (const std::exception& e) {
    std::cerr << "FATAL " << e.what() << "\n";
    return 1;
  }
  std::cout << "CPP MINI OK\n";
  return 0;
}
"""


def p19_cpp_build():
    """The port's C++ client (library and programs) and phase 19's driver
    against it, built with g++; run beside phase 0's kernel build."""
    from ray_tpu_torch._native import cpp_client

    t0 = time.perf_counter()
    os.makedirs(P19_CPP_DIR, exist_ok=True)
    src = os.path.join(P19_CPP_DIR, "p19_driver.cpp")
    with open(src, "w") as f:
        f.write(P19_DRIVER)
    lib = cpp_client.build()
    driver = cpp_client.build_program(
        src, os.path.join(P19_CPP_DIR, "p19_driver"))
    return {"lib": str(lib), "driver": str(driver),
            "s": time.perf_counter() - t0}


def p19_start_cpp(cpp, addr, session, m2, seed):
    """Start phase 19's C++ driver on the CLI's cluster with phase 2's
    mini prompts: (the process, its start time)."""
    spec = os.path.join(P19_DIR, "spec.txt")
    with open(spec, "w") as f:
        f.write(f"{seed} {len(m2['outs'][0])}\n")
        for prompt in m2["prompts"]:
            f.write(" ".join(map(str, prompt)) + "\n")
    token = open(os.path.join(session, "auth.token")).read().strip()
    return (subprocess.Popen([cpp["driver"], addr, token, spec],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True), time.perf_counter())


def p19_finish_cpp(started, m2):
    """Wait for the C++ driver and hold what it printed to phase 2's mini
    streams."""
    proc, t0 = started
    stdout, stderr = proc.communicate(timeout=300)
    wall_s = time.perf_counter() - t0
    with open(os.path.join(P19_DIR, "cpp_driver.log"), "w") as f:
        f.write(stdout + stderr)
    check(proc.returncode == 0,
          f"19: the C++ driver exited {proc.returncode}: "
          f"{stdout[-2000:]} {stderr[-2000:]}")
    lines = stdout.splitlines()
    fields = {line.split(" ", 1)[0]: line.split(" ", 1)[1]
              for line in lines if " " in line}
    streams = [[int(t) for t in line.split()[2:]] for line in lines
               if line.startswith("STREAM ")]
    same = sum(a == b for a, b in zip(streams, m2["outs"]))
    p1, steps = int(fields["P1"]), int(fields["STEPS"])
    print(f"  19 C++ driver (no Python runtime): p19_serve_mini registered "
          f"({fields['REGISTERED']}), {len(streams)} streams printed, "
          f"{same} of {len(m2['outs'])} equal phase 2's; P1 {p1} launches "
          f"= 12 x {steps} decode steps; call {float(fields['CALL_S']):.2f} s "
          f"from the driver's start to its last stream ({wall_s:.2f} s in "
          f"all); unregistered name: {fields.get('RAISED', '')[:120]!r} "
          f"[{card_line()}]")
    check(fields["REGISTERED"].startswith("1 "),
          f"19: xfn:p19_serve_mini not in the head KV: {fields}")
    check(len(streams) == len(m2["outs"]) and same == len(m2["outs"]),
          f"19: {same} of {len(m2['outs'])} C++ streams equal phase 2's")
    check(p1 > 0 and p1 == 12 * steps,
          f"19: C++ call's P1 launches {p1} for {steps} decode steps")
    check("p19_never_registered" in fields.get("RAISED", "")
          and "not registered" in fields["RAISED"],
          f"19: the unregistered call: {fields.get('RAISED')!r}")
    check(lines[-1] == "CPP MINI OK", f"19: driver's last line {lines[-1]}")
    return {"p1": p1, "steps": steps, "same": same,
            "call_s": float(fields["CALL_S"]), "wall_s": wall_s}


def p19_cli(*args, timeout=120):
    """``python -m ray_tpu_torch.scripts <args>`` from the repo root."""
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", *args],
        capture_output=True, text=True, timeout=timeout)
    check(proc.returncode == 0,
          f"19: scripts {' '.join(args)} exited {proc.returncode}: "
          f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    return proc.stdout


def p19_daemons(session):
    """Live processes running the port's daemon on ``session``."""
    mine = []
    for cmdline in glob.glob("/proc/[0-9]*/cmdline"):
        try:
            with open(cmdline, "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if b"ray_tpu_torch.daemon" in argv and session.encode() in argv:
            mine.append(int(cmdline.split("/")[2]))
    return mine


def p19_dashboard(addr, session, timeout=120):
    """`scripts dashboard --port 0` on the cluster, in a process of its own
    (its output in P19_DIR): (the process, its URL)."""
    log = os.path.join(P19_DIR, "dashboard.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.scripts", "--address",
             addr, "--session-dir", session, "dashboard", "--port", "0"],
            stdout=f, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and proc.poll() is None:
        for line in open(log):
            if line.startswith("dashboard at "):
                return proc, line.split()[2]
        time.sleep(0.2)
    proc.kill()
    check(False, f"19: the dashboard did not come up: "
          f"{open(log).read()[-2000:]}")


def p19_rest(url, route, body=None, text=False):
    """One request to the dashboard: a POST of ``body`` as JSON, else a
    GET; the reply parsed as JSON unless ``text``."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(
            url + route, data=data, method="GET" if data is None else
            "POST"), timeout=60) as reply:
        out = reply.read().decode()
    return out if text else json.loads(out)


def phase19(seed, m2, cpp_build):
    """`start --head` with the card detected, a job submitted through the
    dashboard's REST that serves phase 2's mini prompts from a num_gpus=1
    task and registers p19_serve_mini, the CLI's reads, the C++ driver's
    call (``cpp_build``: the future of ``p19_cpp_build``), `stop`. It
    needs no runtime in this process, so it runs while phase 17c's fit
    does."""
    import ast

    print("phase 19: the port's cluster from its CLI, a job serving mini")
    t0 = time.perf_counter()
    session = os.path.abspath(os.path.join(P19_DIR, "session"))
    shutil.rmtree(P19_DIR, ignore_errors=True)
    os.makedirs(P19_DIR, exist_ok=True)
    out = p19_cli("start", "--head", "--port", "0", "--session-dir",
                  session)
    addr = open(os.path.join(session, "head.addr")).read().strip()
    pids = p19_daemons(session)
    check(len(pids) == 1, f"19: daemons after start: {pids}")
    status = p19_cli("--address", addr, "--session-dir", session, "status")
    totals = [ast.literal_eval(line.split("total=")[1].split("  available")[0])
              for line in status.splitlines() if "total=" in line]
    start_s = time.perf_counter() - t0
    print(f"  19 start --head: {out.splitlines()[0]}; status: "
          f"{len(totals)} node, resources {totals} ({start_s:.2f} s from "
          f"start to a registered node)")
    check(len(totals) == 1 and totals[0].get("GPU") == 1.0,
          f"19: the node's resources {totals}, not one GPU")

    spec = os.path.abspath(os.path.join(P19_DIR, "spec.json"))
    result = os.path.abspath(os.path.join(P19_DIR, "result.json"))
    script = os.path.abspath(os.path.join(P19_DIR, "job_mini.py"))
    with open(spec, "w") as f:
        json.dump({"seed": seed, "prompts": m2["prompts"],
                   "max_tokens": len(m2["outs"][0])}, f)
    with open(script, "w") as f:
        f.write(P19_JOB.format(repo=os.path.abspath("."), spec=spec,
                               result=result))
    dash, url = p19_dashboard(addr, session)
    try:
        t1 = time.perf_counter()
        job_id = p19_rest(url, "/api/jobs", {
            "entrypoint": f"{sys.executable} {script}"})["job_id"]
        deadline = time.monotonic() + 600
        while True:
            status = p19_rest(url, f"/api/jobs/{job_id}")["status"]
            if status in ("SUCCEEDED", "FAILED", "STOPPED") \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        job_s = time.perf_counter() - t1
        logs = p19_rest(url, f"/api/jobs/{job_id}/logs", text=True)
        listed = [j["job_id"] for j in p19_rest(url, "/api/jobs")]
    finally:
        dash.terminate()
        dash.wait(timeout=30)
    check(status == "SUCCEEDED",
          f"19: job {job_id} ended {status}; its log:\n{logs[-3000:]}")
    check(job_id in listed, f"19: {job_id} not in /api/jobs {listed}")
    got = json.load(open(result))
    same = sum(a == b for a, b in zip(got["streams"], m2["outs"]))
    print(f"  19 job {job_id}: SUCCEEDED {job_s:.2f} s after submit; "
          f"{same} of {len(m2['outs'])} streams equal phase 2's mini "
          f"streams; the task's P1 launches {got['p1']} = 12 x "
          f"{got['steps']} decode steps [{card_line()}]")
    check(same == len(m2["outs"]),
          f"19: {same} of {len(m2['outs'])} job streams equal phase 2's")
    check(got["p1"] > 0 and got["p1"] == 12 * got["steps"],
          f"19: P1 launches {got['p1']} for {got['steps']} decode steps")

    cpp = cpp_build.result()
    print(f"  19 the port's C++ client and phase 19's driver built by g++ "
          f"in {cpp['s']:.2f} s beside phase 0 ({cpp['lib']})")
    # The C++ call runs while the CLI reads the cluster.
    driver = p19_start_cpp(cpp, addr, session, m2, seed)
    try:
        jobs = json.loads(p19_cli("--address", addr, "--session-dir",
                                  session, "list", "jobs"))
        head = json.loads(p19_cli("--address", addr, "--session-dir",
                                  session, "head", "--json"))
        mem = json.loads(p19_cli("--address", addr, "--session-dir",
                                 session, "mem", "--json"))
        check(any(j["job_id"] == job_id and j["status"] == "SUCCEEDED"
                  for j in jobs), f"19: list jobs {jobs}")
        check(head.get("nodes", 0) >= 1, f"19: head --json {head}")
        check("nodes" in mem, f"19: mem --json {mem}")
        xl = p19_finish_cpp(driver, m2)
    finally:
        if driver[0].poll() is None:
            driver[0].kill()
            driver[0].wait()
    p19_cli("stop", "--session-dir", session)
    deadline = time.monotonic() + 15
    while (p19_daemons(session) or any(pid_alive(p) for p in pids)) \
            and time.monotonic() < deadline:
        time.sleep(0.2)
    left = p19_daemons(session) + [p for p in pids if pid_alive(p)]
    check(not left, f"19: daemons alive after stop: {left}")
    total_s = time.perf_counter() - t0
    print(f"  19 list, head --json, mem --json exited 0; stop left no "
          f"daemon; phase 19 {total_s:.1f} s")
    return {"start_s": start_s, "job_s": job_s, "p1": got["p1"],
            "steps": got["steps"], "same": same, "cpp_build_s": cpp["s"],
            "cpp": xl, "s": total_s}


# ------------------------------------------------------------ phase 20
# An autoscaled GPU node serving mini from an ActorPool. The head node
# offers no GPU, so the two half-GPU actors are demand only a new node can
# meet: the autoscaler adds one, the actors serve pool items on it, and
# once they are killed the idle node goes.
P20_TYPE = {"CPU": 2.0, "GPU": 1.0}
P20_INTERVAL_S = 0.25
P20_IDLE_S = 2.0
P20_REAP_LIMIT_S = P20_IDLE_S + 12 * P20_INTERVAL_S  # from the kills
# A stopped node leaves the head's table when its keepalives stop for the
# head's HEALTH_TIMEOUT_S (30 s by default), as in the JAX package: the
# phase's runtime takes 3 s (keepalives every 1 s, a check every 1 s), so
# that the head counts no GPU within P20_GONE_S of the node's termination.
P20_HEALTH_S = 3.0
P20_GONE_S = P20_HEALTH_S + 3.0


class P20Server:
    """A model on the device in an actor: serves the prompts of one pool
    item greedy, its decode loop wrapped in a tqdm_ray bar, and puts
    (item, P1 launches, decode steps, pid) read from its engine's counters
    on ``queue``."""

    def __init__(self, seed, model="mini", device="cuda"):
        from ray_tpu_torch.llm.engine import LLMEngine
        from ray_tpu_torch.models.llama import PRESETS, init_params

        self.stamps = {"init": time.time()}
        cfg = PRESETS[model]
        params = init_params(cfg, seed, device=device, dtype=cfg.dtype)
        if device == "cuda":
            torch.cuda.synchronize()
        self.stamps["drawn"] = time.time()
        self.device = device
        self.eng = LLMEngine(cfg, max_batch=8, max_seq=2048, params=params,
                             kv="paged", page_size=64, seed=seed,
                             device=device)
        self.stamps["engine"] = time.time()

    def node_addr(self):
        """The node's address, and the wall clock of the process's start
        and of its constructor's steps."""
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        start = boot + ticks / os.sysconf("SC_CLK_TCK")
        return os.environ["RAY_TPU_NODE_ADDR"], {"start": start,
                                                  **self.stamps}

    def serve(self, item, prompts, max_tokens, queue):
        from ray_tpu_torch.experimental import tqdm_ray
        from ray_tpu_torch.llm.engine import SamplingParams

        eng = self.eng
        before = eng.stats()
        sampling = SamplingParams(max_tokens=max_tokens)
        order = {eng.add_request(p, sampling): i
                 for i, p in enumerate(prompts)}
        outs = [None] * len(prompts)
        made = before["tokens_generated"]
        with tqdm_ray.tqdm(desc=f"p20 item {item}",
                           total=max_tokens * len(prompts)) as bar:
            while eng.has_unfinished():
                for fin in eng.step():
                    outs[order[fin["request_id"]]] = fin["tokens"]
                now = eng.stats()["tokens_generated"]
                bar.update(now - made)
                made = now
        if self.device == "cuda":
            torch.cuda.synchronize()
        after = eng.stats()
        p1 = (after["kernel_launches"]["paged_attention"]
              - before["kernel_launches"]["paged_attention"])
        queue.put((item, p1, after["decode_steps"] - before["decode_steps"],
                   os.getpid()))
        return {"item": item, "streams": outs}


def p20_provider():
    """FakeNodeProvider that stamps each create (after the node registered
    with the head: NodeManager.start registers it) and terminate."""
    from ray_tpu_torch.autoscaler import FakeNodeProvider

    class StampedProvider(FakeNodeProvider):
        def __init__(self):
            super().__init__()
            self.created, self.terminated = [], []

        def create_node(self, node_type, resources):
            pid = super().create_node(node_type, resources)
            self.created.append((pid, time.perf_counter()))
            return pid

        def terminate_node(self, provider_node_id):
            super().terminate_node(provider_node_id)
            self.terminated.append((provider_node_id, time.perf_counter()))

    return StampedProvider()


def p20_wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"20: {what} in {timeout} s")
        time.sleep(0.05)


def phase20(seed, m2, model="mini", device="cuda"):
    """The autoscaler's scale-up, serving through an ActorPool, a Queue
    and tqdm_ray bars on the new node, and its scale-down."""
    import io

    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import Autoscaler, NodeTypeConfig
    from ray_tpu_torch.experimental import tqdm_ray
    from ray_tpu_torch.models.llama import PRESETS, init_params
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.actor_pool import ActorPool
    from ray_tpu_torch.util.queue import Queue

    print(f"phase 20: an autoscaled GPU node serving {model} from an "
          "ActorPool")
    cfg = PRESETS[model]
    t0 = time.perf_counter()
    rt.init(num_cpus=4, resources={"GPU": 0.0},
            _system_config={"HEALTH_TIMEOUT_S": P20_HEALTH_S})
    provider = p20_provider()
    scaler = Autoscaler(provider, {"gpu": NodeTypeConfig(
        resources=P20_TYPE, max_workers=1)}, interval_s=P20_INTERVAL_S,
        idle_timeout_s=P20_IDLE_S)
    try:
        check(not rt.cluster_resources().get("GPU"),
              f"20: the head offers GPU {rt.cluster_resources()}")
        sink = io.StringIO()
        tqdm_ray.enable_display(out=sink)
        queue = Queue()
        scaler.start()
        t_demand, wall_demand = time.perf_counter(), time.time()
        cls = rt.remote(P20Server).options(num_gpus=0.5)
        # An actor's .remote() returns once its constructor has run: the
        # two start at once, from two threads, or their cold starts (a
        # worker importing torch and opening a CUDA context) add up.
        with concurrent.futures.ThreadPoolExecutor(2) as starter:
            actors = list(starter.map(
                lambda _: cls.remote(seed, model, device), range(2)))
        placed = rt.get([a.node_addr.remote() for a in actors], timeout=300)
        t_actors = time.perf_counter()
        addrs = [addr for addr, _ in placed]
        # Seconds from the demand to each actor's process start, its
        # constructor, its weights drawn and its engine made.
        ups = [{k: round(v - wall_demand, 2) for k, v in st.items()}
               for _, st in placed]
        check(len(provider.created) == 1,
              f"20: {len(provider.created)} nodes created for two half-GPU "
              "actors, not one")
        (pid, t_node), = provider.created
        check(list(provider.non_terminated_nodes()) == [pid],
              f"20: the provider lists {provider.non_terminated_nodes()}")
        nid = provider.runtime_node_id(pid)
        nodes = {n["node_id"]: n for n in state.list_nodes()}
        check(nid in nodes, f"20: provider node {pid} maps to {nid}, not a "
              f"registered node {sorted(nodes)}")
        check(nodes[nid]["resources"] == P20_TYPE,
              f"20: the new node's resources {nodes[nid]['resources']}")
        check(addrs == [nodes[nid]["addr"]] * 2,
              f"20: actors on {addrs}, not the new node "
              f"{nodes[nid]['addr']}")

        prompts, want = m2["prompts"], m2["outs"]
        max_tokens = len(want[0])
        items = list(enumerate(prompts))
        half = len(items) // 2
        pool = ActorPool(actors)

        def serve(actor, value):
            return actor.serve.remote(value[0], [value[1]], max_tokens,
                                      queue)

        outs, t_first = [None] * len(items), None
        ordered = []
        for got in pool.map(serve, items[:half]):
            t_first = t_first or time.perf_counter()
            ordered.append(got["item"])
            outs[got["item"]] = got["streams"][0]
        check(ordered == list(range(half)),
              f"20: ActorPool.map gave items {ordered}, not in order")
        unordered = [got for got in pool.map_unordered(serve, items[half:])]
        for got in unordered:
            outs[got["item"]] = got["streams"][0]
        check(sorted(g["item"] for g in unordered)
              == list(range(half, len(items))),
              f"20: map_unordered gave items "
              f"{[g['item'] for g in unordered]}")
        check({tuple(g["streams"][0]) for g in unordered}
              == {tuple(outs[i]) for i in range(half, len(items))},
              "20: map_unordered's set of streams")
        serve_s = time.perf_counter() - t_demand
        records = sorted(queue.get(timeout=60) for _ in items)
        check([r[0] for r in records] == list(range(len(items))),
              f"20: queue records {records}")
        for item, p1, steps, _ in records:
            check(p1 > 0 and p1 == cfg.n_layers * steps,
                  f"20: item {item}: P1 launches {p1} for {steps} decode "
                  "steps")
        pids = {r[3] for r in records}
        check(len(pids) == 2, f"20: items served by processes {pids}")
        bars = {i: f"[p20 item {i}] {max_tokens}/{max_tokens} done"
                for i in range(len(items))}
        p20_wait(lambda: all(b in sink.getvalue() for b in bars.values()),
                 15, f"the tqdm display did not see every bar done: "
                 f"{sink.getvalue()[-600:]!r}")

        t_kill = time.perf_counter()
        for a in actors:
            rt.kill(a)
        # The stamp, not the provider's list: the list drops the node
        # before terminate_node has stopped it and stamped the time.
        p20_wait(lambda: provider.terminated, P20_REAP_LIMIT_S,
                 "the idle node was not terminated")
        check(not provider.non_terminated_nodes(),
              f"20: the provider lists {provider.non_terminated_nodes()}")
        reap_s = provider.terminated[0][1] - t_kill
        p20_wait(lambda: not rt.cluster_resources().get("GPU"), P20_GONE_S,
                 f"the head still counts GPU {rt.cluster_resources()}")
        gone_s = time.perf_counter() - provider.terminated[0][1]
        queue.shutdown()
    finally:
        scaler.stop()
        for left in list(provider.non_terminated_nodes()):
            provider.terminate_node(left)
        rt.shutdown()
    same = sum(a == b for a, b in zip(outs, want))
    if same < len(want):
        params = init_params(cfg, seed, device=device, dtype=cfg.dtype)
        stream_check(cfg, params, prompts, outs, f"20 {model} from the pool",
                     device)
        del params
    total_s = time.perf_counter() - t0
    p1 = sum(r[1] for r in records)
    steps = [r[2] for r in records]
    print(f"  20 {model} through ActorPool (map {half} items ordered, "
          f"map_unordered {len(items) - half}): {same} of {len(want)} streams"
          f" equal phase 2's (the rest held by stream_check); demand to a "
          f"registered node {t_node - t_demand:.2f} s, to both actors up "
          f"{t_actors - t_demand:.2f} s (per actor, s from the demand: "
          f"{ups}), to the first result "
          f"{t_first - t_demand:.2f} s, to the last {serve_s:.2f} s; P1 "
          f"launches {p1} = {cfg.n_layers} x {sum(steps)} decode steps "
          f"({steps} per item); node reaped {reap_s:.2f} s after the kills "
          f"(limit {P20_REAP_LIMIT_S:g}), its GPU off the head's table "
          f"{gone_s:.2f} s later; phase 20 {total_s:.1f} s "
          f"[{card_line()}]")
    return {"node_s": t_node - t_demand, "first_s": t_first - t_demand,
            "actors_s": t_actors - t_demand, "ups": ups,
            "serve_s": serve_s, "reap_s": reap_s, "gone_s": gone_s,
            "same": same, "p1": p1,
            "steps": sum(steps), "s": total_s}


# ------------------------------------------------------------ phase 21
# The perf harnesses' serving rows (_private/llm_perf.py) and the
# paged-decode row of _private/perf.py on the card. The op rows are
# llm_perf's three shapes: the bench model's heads, llama3_8b's, and
# llama3_8b's at an 8k-token table whose slots are mostly short.
P21_OP_ROWS = {
    "paged_attention_op@64_h8kv4": {"heads": (8, 4)},
    "paged_attention_op@64_h32kv8": {"heads": (32, 8)},
    "paged_attention_op@64_8k_window": {
        "heads": (32, 8), "max_pages": 128, "long_len": 7000,
        "short_len": 300, "long_every": 8},
}
P21_STEPS = 20  # timed steps of the op rows and of decode@64
# decode@64's streams held by stream_check: 4 long requests, 4 short
P21_CHECKED = (0, 4, 8, 12, 1, 2, 3, 5)


# The op rows' kernel against the gather body: phase 1's one-block limit
# for bf16 P1 (2e-2 per element) and a norm-relative limit. The gather
# body rounds p against each row's max, the kernel against each page's
# running max: in bf16 the split plain version and the gather body sit
# 2.9e-3-3.0e-3 apart by norm at h8kv4 and h32kv8, and leaving out the
# second-last page of every long slot moves the output 5.0e-2-5.3e-2 (CPU
# readings, attention_op_case's inputs; PERF.md).
P21_GATHER_NORM = 1e-2


def p21_op_rows(steps, rows=None, device="cuda"):
    """(a) Each op row: the kernel held to the split plain version at the
    wrapper's split (PAGED_BF16_TOL, PAGED_BF16_NORM, as phase 1 holds
    bf16 P1) and to the gather body (2e-2, P21_GATHER_NORM) on the same
    inputs, then llm_perf's amortized timing of both, beside the bound of
    the live K/V bytes. The timing loops' launches are a measurement's,
    counted in no row of the kernels line."""
    from ray_tpu_torch._private import llm_perf
    from ray_tpu_torch.ops.paged_attention import (
        kernel_split,
        paged_attention,
        paged_attention_split_reference,
    )

    out = {}
    atol, rtol = PAGED_BF16_TOL
    for name, kw in (rows or P21_OP_ROWS).items():
        args, gather = llm_perf.attention_op_case(device=device, **kw)
        got = paged_attention(*args)
        pps = kernel_split(*args[:2], args[3]) if device == "cuda" else 1
        err = compare(f"21a {name}: kernel vs split ({pps} pages/split)",
                      got, paged_attention_split_reference(*args, pps),
                      atol, rtol, PAGED_BF16_NORM)
        err = max(err, compare(f"21a {name}: kernel vs gather path", got,
                               gather(*args), 2e-2, 2e-2, P21_GATHER_NORM))
        del got
        q, kp = args[0], args[1]
        live = int((args[4].long() + 1).sum())  # K = 1: positions + 1 keys
        elt = kp.element_size()
        nbytes = (2 * live * kp.shape[1] * kp.shape[3] * elt
                  + 2 * q.numel() * elt + args[3].numel() * 4
                  + args[4].numel() * 4)
        bound_ms, by = bound_of(nbytes, 4 * q.shape[2] * q.shape[3] * live)
        del args, gather
        row = llm_perf.bench_attention_op_batch64(steps=steps, device=device,
                                                  **kw)
        row.update(bound_us=bound_ms * 1e3, bound_by=by, live_tokens=live,
                   max_abs_err=err)
        out[name] = row
        print(f"  21a {name}: kernel_us {row['kernel_us']:.1f}, gather_us "
              f"{row['gather_us']:.1f}, speedup {row['speedup']:.3f}; bound "
              f"{row['bound_us']:.1f} us by {by} ({live} live tokens)")
    return out


def p21_streams(eng, requests):
    """The token streams of ``requests`` ((request id, prompt) pairs),
    still active in ``eng``."""
    by_id = {r.request_id: list(r.out_tokens) for r in eng._active.values()}
    return [by_id[rid] for rid, _ in requests]


def p21_kernel_row(cfg, positions, name, where, max_pages=32, err_seed=11):
    """A kernels-line row of phase 21: P1 at one of its engines' shapes
    (K=1, the bench model's heads, ``max_pages``-page tables, the engine's
    positions after its timed steps) held to the split plain version at
    the wrapper's split as phase 1 holds bf16 P1 (poisoned stale cells),
    then timed as timing_serving times P1. paged_attention_bench is
    decode@64's (B=64, 32 pages), paged_attention_stall the prefill
    stall's (B=9, 128 pages)."""
    from ray_tpu_torch.ops.paged_attention import (
        kernel_split,
        paged_attention,
        paged_attention_split_reference,
    )

    args = paged_case(len(positions), 1, positions, max_pages, cfg.dtype,
                      seed=err_seed, n_heads=cfg.n_heads,
                      n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim)
    pps = kernel_split(*args[:2], args[3])
    atol, rtol = PAGED_BF16_TOL
    err = compare(f"21 {name} vs split ({pps} pages/split)",
                  paged_attention(*args),
                  paged_attention_split_reference(*args, pps), atol, rtol,
                  PAGED_BF16_NORM)
    del args
    r = time_paged(cfg, positions, 1, max_pages=max_pages)
    print(f"  {name} at {where}: {r.pop('pages_per_split')} pages per "
          f"split, host time per wrapper call {r.pop('host_us'):.1f} us")
    return dict(r, max_abs_err=err)


def phase21(seed, model="bench", mini="mini", device="cuda",
            steps=P21_STEPS):
    """llm_perf's rows (a)-(c) and perf.llm_decode_bench (d) on the card,
    with the checks the docstring lists; returns the readings and the P1
    launches of (b) (the kernels line's paged_attention_bench), of (c)
    (paged_attention_stall) and of (d) (added to paged_attention_d64)."""
    from ray_tpu_torch._private import llm_perf, perf
    from ray_tpu_torch.models.llama import PRESETS, init_params

    t0 = time.perf_counter()
    print("phase 21: the perf harnesses' serving rows")
    ops = p21_op_rows(steps, device=device)

    cfg = PRESETS[model]
    params = init_params(cfg, seed, device=device, dtype=cfg.dtype)
    sync()
    seen = {}

    def decode_inspect(label, eng, requests):
        sync()
        seen[label] = {
            "p1": counts()[0], "steps": eng.stats()["decode_steps"],
            "kernel": eng.paged_attn_kernel,
            "streams": p21_streams(eng, requests),
            "prompts": [p for _, p in requests],
            "positions": [int(eng._positions[i]) for i in range(64)],
        }

    reset_counts()
    decode = llm_perf.bench_decode_batch64(params, steps=steps, model=model,
                                           device=device,
                                           inspect=decode_inspect)
    kern, gath = seen["kernel"], seen["gather"]
    prompts = kern["prompts"]
    check(kern["kernel"] and not gath["kernel"],
          "21b: the engines did not take the kernel and the gather path")
    check(kern["p1"] > 0 and kern["p1"] == cfg.n_layers * kern["steps"],
          f"21b: P1 launched {kern['p1']} times for {kern['steps']} decode "
          f"steps of the kernel engine")
    check(gath["p1"] == kern["p1"],
          f"21b: the gather engine launched P1 {gath['p1'] - kern['p1']} "
          "times")
    first = [(a[:2], b[:2]) for a, b in zip(kern["streams"],
                                            gath["streams"])]
    check(all(a[0] == b[0] for a, b in first),
          "21b: the prefill's token differs between the engines")
    differ = [i for i, (a, b) in enumerate(first) if a != b]
    held = sorted(set(P21_CHECKED) | set(differ))
    for label, s in (("kernel", kern), ("gather", gath)):
        stream_check(cfg, params, [prompts[i] for i in held],
                     [s["streams"][i] for i in held],
                     f"21b decode@64 {label} engine", device)
    print(f"  21b decode@64 ({model}, {cfg.n_layers} layers): kernel "
          f"{decode['kernel']['tok_per_s']:.1f} tok/s, "
          f"{decode['kernel']['ms_per_step']:.2f} ms/step; gather "
          f"{decode['gather']['tok_per_s']:.1f} tok/s, "
          f"{decode['gather']['ms_per_step']:.2f} ms/step; speedup "
          f"{decode['speedup']:.3f}; first decoded token equal in "
          f"{64 - len(differ)} of 64 requests, {len(held)} requests' streams "
          f"held by stream_check; P1 {kern['p1']} = {cfg.n_layers} x "
          f"{kern['steps']} decode steps, the gather engine 0")

    stall_seen = {}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def stall_inspect(label, eng, requests):
        sync()
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        stall_seen[label] = {
            "p1": counts()[0], "steps": eng.stats()["decode_steps"],
            "chunks": eng.stats()["prefill_chunks"],
            "streams": p21_streams(eng, requests),
            "prompts": [p for _, p in requests],
            "positions": [int(eng._positions[i]) for i in range(9)],
            "peak_gib": peak / 2**30,
        }

    p1_before = counts()[0]
    stall = llm_perf.bench_prefill_stall(params, model=model, device=device,
                                         inspect=stall_inspect)
    ch, mono = stall_seen["chunked"], stall_seen["monolithic"]
    want_chunks = 2 * -(-7936 // 1024)  # the warm and the timed prompt
    check(ch["chunks"] == want_chunks,
          f"21c: the chunked engine ran {ch['chunks']} prefill chunks, not "
          f"{want_chunks}")
    check(mono["chunks"] == 0,
          f"21c: the monolithic engine ran {mono['chunks']} prefill chunks")
    stall_p1 = mono["p1"] - p1_before
    check(ch["p1"] - p1_before == cfg.n_layers * ch["steps"]
          and mono["p1"] - ch["p1"] == cfg.n_layers * mono["steps"],
          f"21c: P1 launches {ch['p1'] - p1_before} / "
          f"{mono['p1'] - ch['p1']} for {ch['steps']} / {mono['steps']} "
          "decode steps")
    # The 8 decode requests, then the 7936-token prompt: its stream starts
    # at the last chunk in the chunked engine, at admission in the other.
    same = ch["streams"][:8] == mono["streams"][:8]
    if not same:
        for label, s in (("chunked", ch), ("monolithic", mono)):
            stream_check(cfg, params, s["prompts"][:8], s["streams"][:8],
                         f"21c {label} engine", device)
    long_ch, long_mono = ch["streams"][8], mono["streams"][8]
    check(len(long_ch) > 0 and len(long_mono) > 0
          and long_ch[0] == long_mono[0],
          f"21c: the long prompt's first token differs between the chunked "
          f"and the monolithic prefill ({long_ch[:1]} / {long_mono[:1]})")
    # Chunked prefill (a page gather per chunk, RoPE past bench's max_seq)
    # and P1 over the long slot's 125 pages, against the dense prefill.
    for label, s in (("chunked", ch), ("monolithic", mono)):
        stream_check(cfg, params, s["prompts"][8:], s["streams"][8:],
                     f"21c {label} engine, the 7936-token prompt", device)
    long_same = next((i for i, (a, b) in enumerate(zip(long_ch, long_mono))
                      if a != b), min(len(long_ch), len(long_mono)))
    print(f"  21c prefill stall ({model}, 7936-token prompt, chunk 1024): "
          + "; ".join(f"{k} p50 {stall[k]['p50_ms']:.2f} ms, p99 "
                      f"{stall[k]['p99_ms']:.2f} ms, max "
                      f"{stall[k]['max_ms']:.2f} ms, peak memory "
                      f"{stall_seen[k]['peak_gib']:.2f} GiB"
                      for k in ("chunked", "monolithic"))
          + f"; stall_ratio_p99 {stall['stall_ratio_p99']:.3f}; prefill "
          f"chunks {ch['chunks']} / {mono['chunks']}; the 8 decode streams "
          + ("equal across the engines" if same else
             "differ, each engine's held by stream_check")
          + f"; the long prompt's stream {len(long_ch)} / {len(long_mono)} "
          f"tokens, the first {long_same} equal, both held by stream_check")
    del params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    reset_counts()
    mini_steps = []
    llm_row = perf.llm_decode_bench(
        quick=True, device=device,
        inspect=lambda eng: mini_steps.append(eng.stats()["decode_steps"]))[0]
    sync()
    mini_p1 = counts()[0]
    mini_layers = PRESETS[mini].n_layers
    check(mini_p1 > 0 and mini_p1 == mini_layers * mini_steps[0],
          f"21d: P1 launched {mini_p1} times serving {mini} for "
          f"{mini_steps[0]} decode steps x {mini_layers} layers")
    print(f"  21d perf.llm_decode_bench(quick=True): {llm_row}; P1 "
          f"{mini_p1} launches = {mini_layers} x {mini_steps[0]} decode "
          "steps")

    results = {**{k: {n: v for n, v in r.items()
                      if n in ("kernel_us", "gather_us", "speedup")}
                  for k, r in ops.items()},
               "decode@64": decode, "prefill_stall": stall}
    try:
        llm_perf.check_floors(results)
    except AssertionError as e:
        check(False, f"21: llm_perf floor or ceiling not met: {e}")
    total_s = time.perf_counter() - t0
    print(f"  21 floors and ceilings hold; phase 21 {total_s:.1f} s "
          f"[{card_line()}]")
    return {"ops": ops, "decode": decode, "stall": stall,
            "llm_decode_bench": llm_row,
            "stall_peak_gib": {k: v["peak_gib"]
                               for k, v in stall_seen.items()},
            "first_token_equal": 64 - len(differ), "stall_same": same,
            "long_equal_tokens": long_same,
            "bench_p1": kern["p1"], "stall_p1": stall_p1, "mini_p1": mini_p1,
            "bench_positions": kern["positions"],
            "stall_positions": ch["positions"], "s": total_s}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def bound_of(nbytes, flops):
    """(bound_ms, bound_by): the larger of the byte and operation times."""
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / BF16_FLOPS * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by


def print_rows(rows):
    for name, r in rows.items():
        print(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library "
              f"{r['library_ms']})")


def time_paged(cfg, positions, kq, max_pages=32, page=64, seed=7):
    """P1 and its one-block plain version at one shape, L2 cold, with the
    bound of that shape's live pages and visible keys."""
    from ray_tpu_torch.ops.paged_attention import (
        kernel_split,
        paged_attention,
        paged_attention_reference,
    )

    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    args = paged_case(len(positions), kq, positions, max_pages, cfg.dtype,
                      seed=seed, page_size=page, n_heads=h, n_kv=hkv,
                      head_dim=dh, poison=False)
    ms = time_ms(lambda: paged_attention(*args))
    plain_ms = time_ms(lambda: paged_attention_reference(*args))
    # The host's share: the wrapper's checks, workspace lookup and launch,
    # 200 calls issued back to back without a sync.
    sync()
    t0 = time.perf_counter()
    for _ in range(200):
        paged_attention(*args)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    sync()
    live_pages = sum((p + kq - 1) // page + 1 for p in positions)
    elt = torch.finfo(cfg.dtype).bits // 8
    nbytes = (2 * live_pages * hkv * page * dh * elt  # K and V pages
              + 2 * args[0].numel() * elt  # q in, out
              + args[3].numel() * 4 + args[4].numel() * 4)
    keys = sum(p + k + 1 for p in positions for k in range(kq))
    # QK and PV, each 2 flops per product
    bound_ms, by = bound_of(nbytes, 4 * h * dh * keys)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=None, host_us=host_us,
                pages_per_split=kernel_split(*args[:2], args[3]))


def paged_row(cfg, positions, err, name):
    """P1 at ``cfg``'s heads: the verify step (batch 8, K = 4) and decode
    at batch 64 (lengths of phase 1's B=64 cases) on lines of their own,
    then the row of the kernels line, the first decode step of phase 2
    (batch 8, K = 1, 32-page table)."""
    lengths64 = np.random.default_rng(1).integers(1, 2000, size=64).tolist()
    for label, pos, kq in (("B=8 K=4 (verify)", positions, 4),
                           ("B=64 K=1", lengths64, 1)):
        r = time_paged(cfg, pos, kq)
        print(f"  {name} {label}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}; {r['pages_per_split']} pages per split)")
    r = time_paged(cfg, positions, 1)
    print(f"  {name} at the first decode step: "
          f"{r.pop('pages_per_split')} pages per split, host time per "
          f"wrapper call {r.pop('host_us'):.1f} us")
    return dict(r, max_abs_err=err)


def timing_serving(cfg, positions, errs, mini_cfg, mini_positions):
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_forward,
        flash_attention_reference,
    )

    print("timing at the main path's shapes")
    rows = {}
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    elt = torch.finfo(cfg.dtype).bits // 8
    rows["paged_attention"] = paged_row(cfg, positions, errs["paged"],
                                        "paged_attention")
    # P1 at head_dim 64, mini's 12 / 4 heads.
    rows["paged_attention_d64"] = paged_row(
        mini_cfg, mini_positions, errs["paged_d64"], "paged_attention_d64")
    # P1 at pages of 16, 32 and 4 tokens, the same first decode step
    # (tables of the same 2048 tokens).
    for page in (16, 32, 4):
        r = time_paged(cfg, positions, 1, max_pages=2048 // page, page=page)
        print(f"  paged_attention_p{page} at the first decode step: "
              f"{r.pop('pages_per_split')} pages per split, host time per "
              f"wrapper call {r.pop('host_us'):.1f} us")
        rows[f"paged_attention_p{page}"] = dict(
            r, max_abs_err=errs[f"paged_p{page}"])
    # F1: the dense prefill of phase 3 (B = 1, S = 1024, causal).
    s = 1024
    g = torch.Generator(device="cpu").manual_seed(8)
    q = torch.randn((1, s, h, dh), generator=g).to("cuda", cfg.dtype)
    k = torch.randn((1, s, hkv, dh), generator=g).to("cuda", cfg.dtype)
    v = torch.randn((1, s, hkv, dh), generator=g).to("cuda", cfg.dtype)
    ms = time_ms(lambda: flash_attention_forward(q, k, v, True))
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, True))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    bound_ms, by = bound_of(
        (2 * q.numel() + k.numel() + v.numel()) * elt + h * s * 4,
        4 * h * dh * (s * (s + 1) // 2),
    )
    rows["flash_fwd"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
        library_ms=library_ms, max_abs_err=errs["flash"],
    )
    print_rows(rows)
    return rows


def timing_training(cfg, errs, batch=16, seq=2048, tag=""):
    """F1 and F2 at a training step's shape (B=16, S=2048, causal, bf16,
    the heads of ``cfg``: the bench preset's at head_dim 128, moe_bench's
    at 64 with ``tag`` "_d64"). The library time of the backward is
    autograd through scaled_dot_product_attention minus its forward."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_backward,
        flash_attention_backward_reference,
        flash_attention_forward,
        flash_attention_reference,
    )

    print(f"timing at the training step's shapes (B={batch}, S={seq}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim})")
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v, do = flash_inputs(batch, seq, cfg.dtype, seed=9, h=h, hkv=hkv,
                               d=dh)
    elt = torch.finfo(cfg.dtype).bits // 8
    tri = seq * (seq + 1) // 2  # causal (query, key) pairs per head
    lse_bytes = batch * h * seq * 4
    rows = {}
    ms = time_ms(lambda: flash_attention_forward(q, k, v, True))
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, True),
                       iters=3, warmup=1)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    library_ms = time_ms(sdpa)
    bound_ms, by = bound_of(
        (2 * q.numel() + k.numel() + v.numel()) * elt + lse_bytes,
        4 * batch * h * dh * tri,
    )
    rows["flash_fwd_train" + tag] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
        library_ms=library_ms, max_abs_err=errs["flash_train" + tag],
    )

    o, lse = flash_attention_forward(q, k, v, True)
    ms = time_ms(lambda: flash_attention_backward(q, k, v, o, lse, do, True))
    plain_ms = time_ms(lambda: flash_attention_backward_reference(
        q, k, v, o, lse, do, True), iters=3, warmup=1)
    for t in (qt, kt, vt):
        t.requires_grad_()
    fwd_ms = time_ms(sdpa)
    fwd_bwd_ms = time_ms(
        lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
    # Inputs q, k, v, O, dO, LSE read once; dq, dk, dv written once.
    bound_ms, by = bound_of(
        (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * elt
        + lse_bytes,
        10 * batch * h * dh * tri,
    )
    rows["flash_bwd" + tag] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
        library_ms=fwd_bwd_ms - fwd_ms, max_abs_err=errs["flash_bwd" + tag],
    )
    print_rows(rows)
    print(f"  library backward: scaled_dot_product_attention forward + "
          f"backward {fwd_bwd_ms:.4f} ms minus forward {fwd_ms:.4f} ms")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ray_tpu_torch import _build
    from ray_tpu_torch.models.llama import PRESETS, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    laps = [t_start]
    lap_s = {}  # label -> seconds, printed again near the end

    def lap(label):
        laps.append(time.time())
        lap_s[label] = round(laps[-1] - laps[-2], 1)
        print(f"{label} took {lap_s[label]:.1f} s")

    card = card_line()
    print(f"phase 0: card {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.time()
    # Phase 19's C++ client and driver build on the host beside nvcc.
    cpp_pool = concurrent.futures.ThreadPoolExecutor(1)
    cpp_build = cpp_pool.submit(p19_cpp_build)
    cpp_pool.shutdown(wait=False)
    logs = _build.build()
    print(f"  kernels built in {time.time() - t0:.1f} s")
    for name, log in logs.items():
        print(f"  {name}: " + "; ".join(ptxas_summary(log)))
    lap("phase 0")

    errs = phase1()
    lap("phase 1")

    cfg = PRESETS["llama3_8b"]
    t0 = time.time()
    params = init_params(cfg, args.seed, device="cuda", dtype=cfg.dtype)
    torch.cuda.synchronize()
    print(f"weights: {cfg.num_params() / 1e9:.2f} B parameters in "
          f"{cfg.dtype}, drawn in {time.time() - t0:.1f} s")
    p2 = phase2(cfg, params, args.seed)
    p2_pages = page_variants(cfg, params, args.seed, p2, (16, 32, 4),
                             "llama3_8b")
    p3 = phase3(cfg, params, args.seed)
    print(f"serving peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # mini (head_dim 64, 12 / 4 heads) at full width and depth.
    mini = PRESETS["mini"]
    params = init_params(mini, args.seed, device="cuda", dtype=mini.dtype)
    print(f"weights: mini, {mini.num_params() / 1e6:.1f} M parameters in "
          f"{mini.dtype}")
    m2 = phase2(mini, params, args.seed, name="mini")
    page_variants(mini, params, args.seed, m2, (16,), "mini")
    m3 = phase3(mini, params, args.seed, name="mini")
    mini_tree = numpy_tree(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    rows = timing_serving(cfg, p2["first_positions"], errs, mini,
                          m2["first_positions"])
    for name, a, b in (("llama3_8b", p2, p3), ("mini", m2, m3)):
        print(f"decode {name}: {a['decode_tokens_per_s']:.1f} tokens/s at "
              f"batch 8, speculative {a['spec_tokens_per_s']:.1f} tokens/s; "
              f"TTFT mean {a['ttft_s_mean']:.3f} s, max "
              f"{a['ttft_s_max']:.3f} s (8 prompts admitted in one step); "
              f"dense 1024-token TTFT {b['ttft_s']:.3f} s [{card}]")
    lap("phases 2-3 and their kernel timing")

    # The serving models go before the trainer's state comes.
    p4 = phase4(args.seed)
    rows.update(timing_training(p4["cfg"], errs))
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 4")
    p5 = phase5(args.seed)
    rows.update(timing_training(p5["cfg"], errs, tag="_d64"))
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 5")
    p6 = phase6(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 6")
    p7 = phase7(args.seed)
    plans = planner_checks(p4, p6, p7)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 7")
    tp_rows = phase8a(p2["first_positions"])
    lap("phase 8a")
    p8 = phase8b(args.seed, p4, p2["outs"])
    lap("phase 8b")
    p9 = phase9(args.seed, p8)
    lap("phase 9")
    gc.collect()
    torch.cuda.empty_cache()
    p10 = phase10(args.seed, mini, mini_tree, m2, m3)
    del mini_tree
    lap("phase 10")
    gc.collect()
    torch.cuda.empty_cache()
    p11 = phase11(args.seed)
    lap("phase 11")
    gc.collect()
    torch.cuda.empty_cache()
    p12 = phase12(args.seed, p4)
    lap("phase 12")
    p13 = phase13(args.seed, p2, m2)
    lap("phase 13")
    p14 = phase14(args.seed)
    lap("phase 14")
    gc.collect()
    torch.cuda.empty_cache()
    p15 = phase15(args.seed, p2, p12)
    lap("phase 15")
    gc.collect()
    torch.cuda.empty_cache()
    p16 = phase16(args.seed, p12)
    lap("phase 16")
    p18 = phase18(args.seed)
    lap("phase 18")
    p17 = phase17(during=lambda: phase19(args.seed, m2, cpp_build))
    p19 = p17["c"]["during"]
    lap("phase 17, with phase 19 during 17c")
    p20 = phase20(args.seed, m2)
    lap("phase 20")
    gc.collect()
    torch.cuda.empty_cache()
    p21 = phase21(args.seed)
    rows["paged_attention_bench"] = p21_kernel_row(
        PRESETS["bench"], p21["bench_positions"], "paged_attention_bench",
        "decode@64's last step")
    rows["paged_attention_stall"] = p21_kernel_row(
        PRESETS["bench"], p21["stall_positions"], "paged_attention_stall",
        "the chunked stall engine's last step", max_pages=128)
    lap("phase 21")
    prof = p4["profile"]
    print(f"train: {p4['tokens_per_s']:.1f} tokens/s, "
          f"{p4['peak_share']:.2%} of dense bf16 peak, step "
          f"{p4['step_ms']:.1f} ms, peak memory {p4['peak_gib']:.2f} GiB; device per step: flash "
          f"forward {prof['flash_fwd']:.1f} ms, flash backward "
          f"{prof['flash_bwd']:.1f} ms, matmuls {prof['matmul']:.1f} ms, "
          f"other {prof['other']:.1f} ms, idle {prof['idle_share']:.1%}; "
          f"CE alone {p4['ce_ms']:.1f} ms, optimizer alone "
          f"{p4['opt_ms']:.1f} ms; bf16 F2 dq run to run max |ddq| "
          f"{errs['dq_spread']:.3e} [{card}]")
    print("remat modes, bench preset B=16 S=2048, one forward + backward: "
          + "; ".join(f"{k} {v['ms']:.1f} ms {v['peak_gib']:.2f} GiB "
                      f"F1 {v['f1']}" for k, v in p4["modes"].items())
          + f" [{card}]")
    mprof = p5["profile"]
    print(f"MoE train (moe_bench, remat full): {p5['tokens_per_s']:.1f} "
          f"tokens/s, step {p5['step_ms']:.1f} ms, peak memory "
          f"{p5['peak_gib']:.2f} GiB, loss {p5['losses'][0]:.4f} -> "
          f"{p5['losses'][-1]:.4f}, aux {p5['aux'][-1]:.5f}; device per "
          f"step: flash forward {mprof['flash_fwd']:.1f} ms, flash backward "
          f"{mprof['flash_bwd']:.1f} ms, matmuls {mprof['matmul']:.1f} ms, "
          f"other {mprof['other']:.1f} ms, idle {mprof['idle_share']:.1%} "
          f"[{card}]")
    print(f"bench_8b recipe: {p6['tokens_per_s']:.1f} tokens/s, "
          f"{p6['per_layer_ms']:.1f} ms per layer, peak memory "
          f"{p6['peak_gib']:.2f} GiB [{card}]")
    print(f"training loop (bench, TokenDataset): {p7['tokens_per_s']:.1f} "
          f"tokens/s, peak memory {p7['peak'] / 2**30:.2f} GiB; checkpoint "
          f"{p7['ckpt_bytes'] / 1e9:.3f} GB saved in {p7['save_s']:.2f} s, "
          f"restored in {p7['restore_s']:.2f} s; resumed losses within "
          f"{p7['max_rel']:.3e} relative [{card}]")
    print("memory planner, predicted / measured GiB: "
          + "; ".join(f"{k} {v['pred_gib']:.2f} / {v['peak_gib']:.2f} "
                      f"({v['err']:+.1%}, factor {v['factor']:.3f})"
                      for k, v in plans.items()) + f" [{card}]")
    print("tp-rank shapes checked in phase 8a, not on a main path here: "
          + "; ".join(f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, "
                      f"bound {v['bound_ms']:.4f} by {v['bound_by']}, "
                      f"library {v['library_ms']})"
                      for k, v in tp_rows.items() if k not in TP_MAIN_ROWS)
          + f" [{card}]")
    print(f"two ranks on one card over gloo (correctness only): "
          f"llama3_8b tp=2 streams equal to phase 2's: "
          f"{p8['same_streams']} of 8; bench losses fsdp=2 "
          f"{p8['fsdp=2']['losses']}, tp=2 {p8['tp=2']['losses']}, one "
          f"process {p8['single']} [{card}]")
    print(f"phase 9, two ranks on one card over gloo (correctness only): "
          f"pipeline pp=2 loss {p9['pipeline']['loss']:.6f}; sp=2 losses "
          f"{p9['sp=2']['losses']}; tp=2 flash_qkv_ffn8 "
          f"{p9['tp=2 ffn8']['losses']}; moe_bench sp=2 "
          f"{p9['moe sp=2']['losses']}; multislice fsdp=2 "
          f"{p9['multislice fsdp=2']['losses']}; sp=2 flash launches "
          f"{p9['sp=2']['f1']} + {p9['sp=2']['f2']} (both ranks, phase 4's "
          f"shape) [{card}]")
    print(f"phase 10, the runtime on the card: init {p10['init_s']:.3f} s; "
          f"first GPU task (F1 at B=1 S=1024, worker spawn, CUDA context and "
          f"kernel load included) {p10['task_s']:.3f} s; GPU actor cold "
          f"start (mini's paged engine from one put of "
          f"{p10['put_bytes'] / 1e9:.3f} GB) {p10['cold_s']:.3f} s; mini "
          f"decode {p10['decode_tokens_per_s']:.1f} tokens/s through the "
          f"actor, {m2['decode_tokens_per_s']:.1f} in process (phase 2) "
          f"[{card}]")
    print(f"phase 10 launches (worker processes, not in the kernels line): "
          f"GPU task F1 {p10['task_f1']}; actor P1 {p10['actor_launches'][0]}"
          f" F1 {p10['actor_launches'][1]} (phase 2 mini greedy P1 / F1 "
          f"{m2['greedy_launches'][0]} / {m2['greedy_launches'][1]}, phase 3 "
          f"mini F1 {m3['launches']})")
    bk = p11["bucketer"]
    print(f"phase 11, collectives: bench gradient tree ({bk['params']} fp32 "
          f"leaves, {bk['bytes_per_rank']} B per rank) synced over "
          f"{P11_RANKS} ranks of one card in {bk['fp32']['buckets']} "
          f"buckets: cold {bk['fp32']['cold_ms']:.1f} ms, warm "
          f"{bk['fp32']['warm_ms']:.1f} ms (bound {bk['bound_ms']:.2f} ms); "
          f"int8 cold {bk['int8']['cold_ms']:.1f} ms, warm "
          f"{bk['int8']['warm_ms']:.1f} ms; 256 MiB transport rpc "
          f"{p11['transport']['rpc']['GB_per_s']:.2f} GB/s, group "
          f"{p11['transport']['group']['GB_per_s']:.2f} GB/s; NCCL, two "
          f"ranks on one card: {p11['nccl_world1']['two_ranks_one_card']} "
          f"[{card}]")
    a12, b12, c12 = p12["a"], p12["b"], p12["c"]
    print(f"phase 12, the Train library: bench state "
          f"{a12['logical_bytes'] / 1e9:.3f} GB through AsyncCheckpointer, "
          f"save() stalls {a12['stall_s'][0]:.3f} s (first, host buffers "
          f"allocated) / {a12['stall_s'][1]:.3f} s (phase 7's torch.save "
          f"of {p7['ckpt_bytes'] / 1e9:.3f} GB {p7['save_s']:.2f} s), "
          f"persist {a12['persist_s']:.2f} s, "
          f"written {a12['written_bytes'] / 1e9:.3f} GB after a step "
          f"(dedup {a12['dedup']:.3f}), restore {a12['restore_s']:.2f} s; "
          f"TorchTrainer at {P12_LAYERS} layers {b12['tokens_per_s']:.1f} "
          f"tokens/s (phase 4 at 24 {p4['tokens_per_s']:.1f}), controller {b12['overhead_s']:.2f} s "
          f"per step, resumed losses within {b12['max_rel']:.3e}; two "
          f"workers fsdp=2 losses {c12['losses']} (one process "
          f"{c12['single']}) [{card}]")
    a13, b13 = p13["a"], p13["b"]
    print(f"phase 13, Serve: llama3_8b from one num_gpus=1 replica behind "
          f"the HTTP proxy: cold start {a13['cold_s']:.2f} s; TTFT at the "
          f"client (4 SSE streams) mean {a13['ttft_mean']:.3f} s, max "
          f"{a13['ttft_max']:.3f} s, the engine's ttft_s (4 unary) mean "
          f"{a13['engine_ttft_mean']:.3f} s, max "
          f"{a13['engine_ttft_max']:.3f} s (phase 2 in process: mean "
          f"{p2['ttft_s_mean']:.3f} s, max {p2['ttft_s_max']:.3f} s); SSE "
          f"decode {a13['sse_tokens_per_s']:.1f} tokens/s per stream "
          f"(phase 2: {p2['decode_tokens_per_s'] / 8:.1f} per stream, "
          f"{p2['decode_tokens_per_s']:.1f} over 8); replica P1 launches "
          f"{a13['p1']} = 32 x {a13['steps']} decode steps; mini on 2 "
          f"half-GPU replicas: P1 launches {b13['launches']}, replacement "
          f"after a SIGKILL healthy in {b13['replace_s']:.2f} s [{card}]")
    print(f"phase 14, compiled graph: {p14['dag_us']:.1f} us per execute() "
          f"(two F1 actors, allreduce of their O on the card), "
          f"{p14['remote_us']:.1f} us for the same two F1 calls by .remote() "
          f"and get; {p14['step_bytes']} B through the shared-memory "
          f"channels per step; us per step, "
          + ", ".join(f"{k} {v:.1f}" for k, v in p14["split"].items())
          + f" [{card}]")
    a15, b15 = p15["a"], p15["b"]
    print(f"phase 15, Ray Data: llama3_8b batch inference through one data "
          f"actor, map_batches to the rows {a15['rows_s']:.2f} s, decode "
          f"{a15['per_stream']:.1f} tokens/s per stream (phase 2: "
          f"{p2['decode_tokens_per_s'] / 8:.1f}), {a15['same']} of 8 "
          f"streams equal phase 2's; TorchTrainer fed by a Dataset "
          f"{b15['tokens_per_s']:.1f} tokens/s (phase 12b "
          f"{p12['b']['tokens_per_s']:.1f}), data_wait per step "
          + ", ".join(f"{w:.4f}" for w in b15["data_wait_s"])
          + f" s, losses within {b15['max_rel']:.3e} of phase 12b's "
          f"[{card}]")
    print(f"phases 13-15 launches (worker processes, not in the kernels "
          f"line): 13a replica P1 {a13['p1']}; 13b replicas P1 "
          f"{b13['launches']}; 14 actors F1 {p14['launches']}; 15a data "
          f"actor P1 {a15['p1']} = 32 x {a15['steps']} decode steps, F1 "
          f"{a15['f1']}; 15b worker F1 + F2 per step {b15['launches']}")
    a16, b16 = p16["a"], p16["b"]
    print(f"phase 16, Tune: 16a LedgerASHA over {len(P16A_LRS)} trials on "
          f"half-GPU leases, stopped at the rung {a16['stopped']}, steps run "
          f"{a16['ran']}, makespan {a16['makespan_s']:.2f} s, "
          f"chip_idle_fraction {a16['idle']}, lr 3e-4 losses within "
          f"{a16['max_rel']:.3e} of phase 12b's; 16b LedgerPBT: "
          f"{b16['forks']} fork of {b16['share']['dst_chunks']} chunks, "
          f"{b16['share']['new_chunks']} new, in {b16['fork_s']:.3f} s; "
          f"saves (stall s, persist s) {b16['saves']}; relaunch to the "
          f"first restored step {b16['to_step_s']:.2f} s, first loss within "
          f"{b16['diff']:.3e} of the winner's; makespan "
          f"{b16['makespan_s']:.2f} s, chip_idle_fraction {b16['idle']} "
          f"[{card}]")
    print(f"phase 16 launches (trial workers): F1 + F2 per step 16a "
          f"{sorted(set(a16['launches']))} over {len(a16['launches'])} "
          f"steps, 16b {sorted(set(b16['launches']))} over "
          f"{len(b16['launches'])} steps (kernels line: flash_fwd_train_sweep"
          f" {a16['f1'] + b16['f1']}, flash_bwd_sweep "
          f"{a16['f2'] + b16['f2']})")
    cap, c16 = p4["capture"], a16["capture"]
    print(f"step profiler: phase 4's capture of the bench step "
          f"{cap['step_ms']:.1f} ms, mfu {cap['mfu']:.4f}, shares "
          + ", ".join(f"{k} {v:.4f}" for k, v in cap["shares"].items())
          + "; device ms per step " + ", ".join(
              f"{k} {v:.1f}" for k, v in cap["ms"].items())
          + f" (attention kernels {cap['attention_ms']:.1f}); largest "
          "elementwise kernels " + "; ".join(
              f"{k[:50]} {v:.2f}" for k, v in cap["elementwise"])
          + f"; phase 16a: {c16['spans']} profile:step spans at the head "
          f"[{card}]")
    a17, b17 = p17["a"], p17["b"]
    print(f"phase 17, RL: PPO mean return {a17['return']:.3f}, learner "
          f"update median {a17['update_ms_median']:.3f} ms, sample "
          f"{a17['sample_ms_median']:.2f} ms per iteration, "
          f"{a17['env_steps_per_s']:.1f} env steps/s, the CPU redo within "
          f"{a17['worst_rel']:.3e} ({a17['worst_key']}); APPO mean return "
          f"{b17['return']:.3f}, update median {b17['update_ms_median']:.3f}"
          f" ms, sample {b17['sample_ms_median']:.2f} ms, "
          f"{b17['env_steps_per_s']:.1f} env steps/s; phase 17 "
          f"{p17['s']:.1f} s [{card}]")
    c17 = p17["c"]
    print(f"phase 17c, the composed pp x ep x fsdp loop through "
          f"TorchTrainer: 4 workers at 0.25 GPU fit in {c17['fit_s']:.2f} s, "
          f"loss {c17['loss']:.8f}, within {c17['worst_rel']:.3e} of the "
          f"plain CPU steps, exposed comm {c17['comm_exposed_s']:.4f} s "
          f"[{card}]")
    print(f"phase 18, ResNet: resnet18 B={P18_BATCH} at {P18_HW} x {P18_HW}, "
          f"bf16 convolutions: {p18['step_ms']:.2f} ms per Adam step, "
          f"{p18['images_s']:.1f} images/s (steps {P18_TIMED[0]}-"
          f"{P18_TIMED[1]}), loss {p18['losses'][0]:.4f} -> "
          f"{p18['losses'][-1]:.4f}; first step against fp32: loss "
          f"{p18['loss_rel']:.3e}, gradient {p18['grad_rel']:.3e} (the "
          f"CPU's bf16 {p18['cpu_grad_rel']:.3e}), each leaf at most "
          f"{p18['leaf_ratio']:.3f} times the CPU's bf16 reading (limit "
          f"{P18_LEAF_K:g});"
          f" resnet50 forward B=8 at 224 x 224 {p18['r50_ms']:.2f} ms; phase "
          f"18 {p18['s']:.1f} s [{card}]")
    print(f"phase 19, the CLI cluster: start --head to a registered GPU node "
          f"{p19['start_s']:.2f} s, the mini job SUCCEEDED "
          f"{p19['job_s']:.2f} s after submit, {p19['same']} of 8 streams "
          f"equal phase 2's, P1 {p19['p1']} launches in the job's task "
          f"(= 12 x {p19['steps']}; added to paged_attention_d64's count); "
          f"C++ client built in {p19['cpp_build_s']:.2f} s beside phase 0; "
          f"the C++ driver's call {p19['cpp']['call_s']:.2f} s to its last "
          f"stream, {p19['cpp']['same']} of 8 streams equal phase 2's, P1 "
          f"{p19['cpp']['p1']} launches (= 12 x {p19['cpp']['steps']}; "
          f"added too); phase 19 {p19['s']:.1f} s [{card}]")
    print(f"phase 20, an autoscaled GPU node: demand to a registered node "
          f"{p20['node_s']:.2f} s, to the first pool result "
          f"{p20['first_s']:.2f} s, all {len(m2['outs'])} items "
          f"{p20['serve_s']:.2f} s, {p20['same']} of {len(m2['outs'])} "
          f"streams equal phase 2's; P1 {p20['p1']} launches in the two "
          f"actors (= 12 x {p20['steps']}; not in the kernels line); the "
          f"idle node reaped {p20['reap_s']:.2f} s after the kills; phase "
          f"20 {p20['s']:.1f} s [{card}]")
    d21 = p21["decode"]
    print(f"phase 21, the perf harnesses: op rows at batch 64 (kernel / "
          f"gather us, speedup, bound us) "
          + "; ".join(f"{k} {v['kernel_us']:.1f} / {v['gather_us']:.1f}, "
                      f"{v['speedup']:.3f}, {v['bound_us']:.1f}"
                      for k, v in p21["ops"].items())
          + f"; decode@64 on bench {d21['kernel']['tok_per_s']:.1f} tok/s "
          f"through P1, {d21['gather']['tok_per_s']:.1f} through the gather "
          f"path (speedup {d21['speedup']:.3f}); prefill stall p99 chunked "
          f"{p21['stall']['chunked']['p99_ms']:.2f} ms, monolithic "
          f"{p21['stall']['monolithic']['p99_ms']:.2f} ms (ratio "
          f"{p21['stall']['stall_ratio_p99']:.3f}); perf's paged decode on "
          f"mini {p21['llm_decode_bench']['tokens_per_s']} tok/s; phase 21 "
          f"{p21['s']:.1f} s [{card}]")
    rows.update({k: tp_rows[k] for k in TP_MAIN_ROWS})
    rows.update(p9["pipeline"]["rows"])
    # Phase 16's trials run the bench step at phase 4's shape: the same
    # timed rows, with the sweep's launches.
    rows["flash_fwd_train_sweep"] = dict(rows["flash_fwd_train"])
    rows["flash_bwd_sweep"] = dict(rows["flash_bwd"])
    print(f"run took {time.time() - t_start:.1f} s; "
          f"{time.time() - _PROCESS_T0:.1f} s since the process started")
    # One row per kernel and main-path shape: the forward kernel runs in
    # the dense prefill (phase 3) and in training (phase 4).
    launches = {"paged_attention": p2["launches"],
                "paged_attention_d64": (m2["launches"] + p19["p1"]
                                        + p19["cpp"]["p1"] + p21["mini_p1"]),
                "paged_attention_bench": p21["bench_p1"],
                "paged_attention_stall": p21["stall_p1"],
                "paged_attention_p16": p2_pages[16]["launches"],
                "paged_attention_p32": p2_pages[32]["launches"],
                "paged_attention_p4": p2_pages[4]["launches"],
                "flash_fwd": p3["launches"],
                "flash_fwd_train": p4["f1_launches"],
                "flash_bwd": p4["f2_launches"],
                "flash_fwd_train_d64": p5["f1_launches"],
                "flash_bwd_d64": p5["f2_launches"],
                "paged_attention_tp2": p8["serve_launches"],
                "flash_fwd_train_tp2": p8["tp=2"]["f1"],
                "flash_bwd_tp2": p8["tp=2"]["f2"],
                "flash_fwd_train_pp": p9["pipeline"]["f1"],
                "flash_bwd_pp": p9["pipeline"]["f2"],
                "flash_fwd_train_sweep": a16["f1"] + b16["f1"],
                "flash_bwd_sweep": a16["f2"] + b16["f2"]}
    fwd = ("ray_tpu_torch/csrc/flash_fwd.cu",
           "ray_tpu/ops/pallas/flash_attention.py:48")
    paged = ("ray_tpu_torch/csrc/paged_attention.cu",
             "ray_tpu/ops/pallas/paged_attention.py:59")
    meta = {
        "paged_attention": paged,
        "paged_attention_d64": paged,
        "paged_attention_p16": paged,
        "paged_attention_p32": paged,
        "paged_attention_p4": paged,
        "paged_attention_bench": paged,
        "paged_attention_stall": paged,
        "flash_fwd": fwd,
        "flash_fwd_train": fwd,
        "flash_bwd": ("ray_tpu_torch/csrc/flash_bwd.cu",
                      "ray_tpu/ops/pallas/flash_attention.py:187"),
    }
    meta["flash_fwd_train_d64"] = fwd
    meta["flash_bwd_d64"] = meta["flash_bwd"]
    meta["paged_attention_tp2"] = paged
    meta["flash_fwd_train_tp2"] = fwd
    meta["flash_bwd_tp2"] = meta["flash_bwd"]
    meta["flash_fwd_train_pp"] = fwd
    meta["flash_bwd_pp"] = meta["flash_bwd"]
    meta["flash_fwd_train_sweep"] = fwd
    meta["flash_bwd_sweep"] = meta["flash_bwd"]
    check(rows.keys() == meta.keys(),
          f"timed rows {sorted(rows)} are not the kernels {sorted(meta)}")
    kernels = [
        {"name": name, "route": "cuda", "source": meta[name][0],
         "replaces": meta[name][1], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in rows.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"collectives": p11}))
    print(json.dumps({"laps": lap_s}))
    print(json.dumps({"llm_perf": {
        **{k: v for k, v in p21["ops"].items()},
        "decode@64": p21["decode"], "prefill_stall": p21["stall"],
        "stall_peak_gib": p21["stall_peak_gib"],
        "llm_decode_bench": p21["llm_decode_bench"],
        "first_token_equal": p21["first_token_equal"],
        "stall_streams_equal": p21["stall_same"],
        "long_prompt_equal_tokens": p21["long_equal_tokens"],
        "s": p21["s"]}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
