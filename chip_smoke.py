"""Chip smoke test of the PyTorch/CUDA port on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--out report.json]

Phases, each reported on lines of its own:

1. build   — compile the CUDA kernels (``src/repro_torch/kernels/
             stmul/csrc``, ``kernels/ssd/csrc``, ``kernels/flash/csrc``
             and ``kernels/conv3d/csrc``) with nvcc for sm_90a, one nvcc
             per library, all started together, and load them; print
             ``-Xptxas -v``'s registers, spills and stack per kernel.
             B6's library must report, for every (dtype, head dim), the
             dynamic shared memory ``kernel.smem_bytes`` plans (at most
             227 KB), and its bf16 builds must hold warpgroup MMAs
             (HGMMA, wgmma) and cp.async copies (LDGSTS) in their SASS
             (``cuobjdump``); B5's chunk-state and chunk-scan kernels
             of every (chunk, P, N) build must hold tensor-core MMAs
             (HMMA, 3xTF32 mma.sync), the scan also cp.async copies; B4's tensor-core kernel
             (``conv3d_tc.cu``) warpgroup MMAs (HGMMA, 3xTF32 wgmma),
             tensor-map copies (UTMALDG) and bulk copies (UBLKCP), its
             implicit-GEMM kernels (``conv3d_igemm.cu``, BN 64 and 128)
             HGMMA and UTMALDG, with no wgmma serialization reported by
             ptxas.
2. serve   — a VideoSearchServer at the paper geometry (60x80 frames,
             four tenants of 9x1x30x40x8 kernels, 64-frame windows, 4
             windows per chunk) answers six 1024-frame requests, two
             sharing one clip: pooled (B2 + B3), sequential (B1 + B3),
             stitched (return_volume, whose fused scores must equal the
             stitched amax/argmax bitwise), and pooled again with bf16
             gratings.  The launch counters are zeroed before and read
             after; every kernel of each rung must have run.  The ideal
             tenant's scores are checked against direct conv3d
             correlation on a short clip, and one call of each rung is
             profiled (host clip hashing, device busy time by kernel,
             every kernel of the repository's own listed).  Then a
             ``max_buffer_windows = 8`` server searches numpy streams of
             4096 and 8192 frames: its peak device memory may grow by
             less than a quarter of the shorter stream's bytes, and its
             detections must equal the unbounded server's bitwise.
             The host clips reach the card through pinned staging; both
             rungs are also timed with the pageable copy it replaced, in
             turns, and profiled once each for the copies' device ms.
3. sched   — the same four tenants behind ``MicrobatchScheduler``
             (max_queue 64, max_batch 6, batch_wait_s 0.005), gratings,
             cuFFT batch sizes and both rungs warmed in the main thread
             first.  Open-loop load: 96 single-stream 1024-frame requests
             per rate, seeded Poisson arrivals at 0.5x, 0.9x, 1.0x, 1.2x
             and 1.5x of the pooled rung's frames/s from the serve phase,
             tenants
             uniform, every third request repeating the previous clip,
             submitted by six client threads; printed: p50/p90/p99
             submit->result latency, delivered frames/s, mean batch,
             dedup groups, rejected, submit ms, lag behind the schedule
             and the phase's B1/B2/B3 launches.  Checks: every future
             resolves with a result, 0 rejected and 0 failed at 0.5x,
             each result within 1e-5 (max relative) of the request
             served alone (peak frames equal unless the alone run's
             volume ties at the scheduled frame), B1 silent while the
             pooled breaker never tripped; above 1.0x a rejection is a
             result.  One more 0.9x replay under torch.profiler splits a
             request's time into SHA-1 at submit, queue wait and its
             batch call, with the device busy ms per batch.  Chaos storm
             (the reference's
             benchmarks/chaos.py rules, a churning tenant, 32 x 256
             frames, every 8th clip NaN): every future resolves, exactly
             the poisoned ones quarantined, the rest results within
             1e-5 of a fault-free alone run or typed ServingErrors, an
             expired deadline typed, nothing pending after close().
             Breaker: a pooled dispatch fault at rate 1 trips the pooled
             breaker; the next batch runs on the sequential rung (B1
             launching, B2 not) within 1e-5 of the pooled answers; with
             the fault removed the ladder is back on pooled.
4. kernels — run every kernel at the shapes the serving batch gives it
             and hold it against its plain torch version on the card:
             B1 v2/v1 bitwise, also at an odd F, at C = 3 (the kernel
             for C > 1) and with 20 kernels (O in chunks that do not fill
             the last); B2 f32/bf16 at the pooled
             rung's shape, with irregular unsorted offsets into a 64-row
             arena and at an odd F, bitwise; the top-K readout (B3, k = 1
             and 3 at 36 rows, k = 1 at 9 and 18; rows with NaN, -inf,
             ties and signed zeros, then inputs with those on the slice
             boundaries of the host plan) bitwise.  Times each with
             CUDA events beside its plain version, a one-call library
             yardstick and its bound (bytes at 3.35 TB/s or float32
             operations at 67 TFLOP/s, whichever is larger).
5. lm      — mamba2-370m at its published config (48 layers, bf16,
             random weights from a seeded generator on the card) served
             by ``LMServer.generate``: 4 prompts x 2048 tokens then 32
             greedy tokens, and 2 x 1000 (padded to 1024 inside the SSD)
             then 8.  One warm-up and 3 timed calls each of prefill-only
             and full generation; the SSD kernel's (B5) launch counter,
             zeroed before the timed calls, must read 48 x the prefills
             run.  B5 is held against its plain version on layer 0's SSD
             operands as the model launches it: the first batch, batch
             two padded to 2 x 1024, and the first prompt alone (1 x
             2048, 32 heads), relative L2 <= 1e-5 for y and the final
             state, its passes' device ms from a profiled prefill of
             the same prompts, and timed like the others (no single PyTorch call computes it:
             library "none"; bound: its FLOPs at the TF32 tensor-core
             rate / 3, the float32 FMA bound beside it); its (16, 16, 16) build,
             which ``serve --mode lm`` runs on the smoke config, is held
             to the same limit on that config; a 2-layer float32 model
             at full width must give the same last logits by the kernel
             route and the plain route (relative L2 <= 1e-4).
6. lm_dense — qwen2-1.5b at its published config (28 layers, d_model
             1536, 12 query and 2 kv heads of 128, bf16, random weights
             from a seeded generator on the card) served by
             ``LMServer.generate`` with a KV cache of prompt + new tokens,
             on the same two batches, timed and profiled as in ``lm``;
             the flash-attention kernel's (B6) launch counter must read
             28 x the prefills run.  B6 in bf16 (the wgmma build)
             is held against its plain version on layer 0's q, k, v of
             both batches and on a bf16 sweep (ragged 37, 130, 1000 and
             1500, Sq != Sk both ways, GQA groups 1, 2, 6 and 7, head dims
             16, 24, 32, 64, 128 and 160, both mask settings): relative
             L2 <= 1e-2 (the
             plain version rounds q·scale to bf16), and against the
             plain version on the same inputs upcast to float32 the
             worst row's relative L2 <= 1e-2 and max abs <= 5e-3
             max|v|; in float32 (the FMA build) on the reference test
             sweep's shapes, the smoke config's head dim 24 and head
             dim 64 (ragged causal, Sq < Sk, a 37 x 1500 cross shape)
             (relative L2 <= 1e-5, max abs <= 3e-5); timed
             beside its plain version, one
             ``scaled_dot_product_attention`` call as the library
             yardstick, and its bound (bytes at 3.35 TB/s or the causal
             triangle's FLOPs at 989 TFLOP/s bf16); a 2-layer float32
             model at full width must give the same last logits by the
             kernel route and the plain route (relative L2 <= 1e-4).
             Decode attention at layer 0's decode shapes: the bf16-GEMM
             route against the ``_dot_f32`` route on the same tensors
             (each product's float32 output within 1e-5, the bf16 output
             within 1e-2), no cache-sized float32 copy, and decode
             ms/token of ``generate`` on each route, in turns.
7. classify — the paper's hybrid 3-D CNN at its full geometry (60x80x16
             clips, 9 kernels of 30x40x8, pool (8, 8, 3), hidden 128, 4
             classes; random weights from a seeded generator on the card)
             on the 144-clip synthetic-KTH test split in batches of 16:
             ``predict`` with impl digital (B4), spectral and
             sthc_physical (B1), and ``HybridClassifierServer.classify``,
             physical and ideal (B1); one warm-up and 7 timed batches per
             route, five profiled calls each.  Then ``classify_stream`` and
             ``conv_layer_stream(impl='digital')`` on four 512-frame
             streams, one per class.  Checks: digital and spectral
             predictions equal outside near-ties (top-two logits within
             1e-4 of their scale), the ideal server equal to
             ``predict(spectral)`` likewise, every ``classify_stream``
             segment equal to ``classify`` of its sub-clip, the streamed
             digital conv within 2e-4 (max error over max) of the
             streamed ideal STHC conv, and B4's launch counter, zeroed
             before the phase, equal to the digital calls made.  B4 is
             held against its plain version (relative L2 <= 1e-5 in
             float32, <= 1e-2 in bf16 against the plain version on the
             same inputs upcast) at the batch and stream shapes (the
             tensor-core route, which ``kernel.route`` must give them),
             kernels_bench's C3D case (float32 and bf16) and the
             reference test sweep's shapes (the FMA route), and timed
             beside it (the
             plain version is one cuDNN ``F.conv3d`` call, so its time is
             also the library time; float32 rows carry both bounds,
             TF32 / 3 and float32 FMA); B1 likewise, bitwise, at the
             classifier's shapes (16 spectra against a (9, 1, F)
             grating, F from the 60x80x16 clip's FFT grid).  The
             ``predict`` routes take host clips through pinned buffers;
             digital and spectral are also timed with the pageable copy
             they replaced, in turns.
             Then C3D at its published widths (``phase_c3d``; seeded
             He-scaled weights) served by ``C3DClassifierServer.classify``
             on 128 clips of 3x112x112x16, the benchmark cell
             ``c3d-clips``'s call: one warm-up, 3 timed calls, then one
             with B4's counters at 0 just before it, which must launch the
             ``igemm`` route 8 times and no other.  Then each of the eight
             layers at 128 clips as the trunk calls it (channels-last,
             one-voxel border, bias, ReLU): ``kernel.route`` must give
             ``igemm``; ``conv3d_cuda`` against ``ref.conv3d_ref`` within
             relative L2 1e-5, which one TF32 pass of cuDNN must fail;
             timed beside the plain version and the library (one cuDNN
             ``F.conv3d`` with bias, TF32 off, and ReLU in place); the
             bound is the cell's yardstick (``portbench/pbench/
             c3d_cost.py``: operations at dense TF32 or bytes at HBM
             bandwidth, the larger), three passes' beside it.
8. train   — the same network trained on the card: one ``digital`` step
             (B4 forward, plain backward) against one ``spectral`` step
             from the seeded init and the first batch of 32 (each
             parameter's gradient within relative L2 1e-4), B4's
             autograd against autograd of its plain version (1e-5),
             ``sthc_physical`` in grad mode raising (B1 has no
             backward), 10 timed steps on each route; then, counted,
             ``train_hybrid.train_steps`` for 45 epochs (270 steps of
             32) on ``spectral`` (AdamW, warmup into a cosine decay; loss
             every 20 steps, median step ms by host clock after a
             synchronize, step 0 excluded), evaluation of val on
             spectral and test on spectral, digital (B4) and
             sthc_physical (B1) with their confusion matrices, digital
             and spectral predictions equal outside near-ties, and the
             fidelity ablation's rows (every stack of
             ``sthc_kth.fidelity_stacks()`` on one grating cache) beside
             ``BENCH_ablation.json``'s accuracies and the paper's 0.5972.
             Checks: test accuracy on spectral and digital >= 0.93,
             every cumulative stack >= 0.90, the last logged loss < 0.35,
             B4 and B1 launched in the counted run; B4 is held against
             its plain version at the training batch and timed.

9. replica — the replicated video search (``launch/replica.py``):
             benchmarks/chaos.py's three replica rows at their request
             counts, on paper-geometry replicas (each its own server and
             scheduler, warmed at every batch size first) holding the
             four tenants, 1024-frame clips.  Storm: 3 replicas, 60
             requests, a 50 ms dispatch latency on r1, r1 killed after
             request 20, hedging after 0.25 s; every future resolves, 0
             lost, availability >= 95 %, every result within 1e-5 of the
             request alone (peak frames equal outside ties); r1
             warm-restarted from the tenant manifest on disk passes the
             bitwise admission probe for all four tenants and answers
             bitwise as a survivor; whether a request's scores depend on
             its batch (pooled rows 1-6, sequential) is printed.  Hedge:
             2 replicas, r0 straggling by max(60 ms, 4x one request
             alone), 40 searches with hedging off, then on after a
             quarter of the straggle: hedges > 0 and wins > 0, both p99s.
             Flap: 2 replicas at the reference's heartbeat thresholds,
             r0 stalled and revived in a loop under 48 requests: every
             future resolves, 0 lost, flaps + deaths > 0.  Each replay
             prints failovers, rescues, hedges, wins, flaps, deaths,
             spurious deaths (members that died unkilled and unstalled),
             p50/p90/p99 and its B1/B2/B3 launches (B2 and B3 must run,
             B1 exactly when a sequential batch ran).  Mesh: 2 replicas,
             each on its own (1, 2) logical mesh of the card, r0 killed
             after 8 of 24 requests: every future a result, 0 lost, every
             result bitwise the single-device server's answer to it; r0
             warm-restarted owns a new LocalMesh and answers the four
             tenants bitwise as the single-device server.  Then the
             phase's seconds and peak device memory.
10. ckpt   — mamba2-370m's parameters (bf16, built on the card by the
             port's init) and a small float32 / int64 tree through
             ``CheckpointManager(async_save=True, keep=2)`` in a
             temporary directory (its free space printed): snapshot ms,
             write s, restore s onto the card, the restore bitwise; a
             ckpt_write fault on a third save must surface on ``wait()``
             with the second save the latest and intact.
11. mesh   — the serve phase's tenants and six requests on a server
             with fused readout at K = 3: on one device, then with
             ``mesh_shape`` (1, 1) on the default devices (the card) and
             (1, 2), (2, 1), (2, 2) and (1, 4) as logical meshes over
             ``mesh_devices=("cuda:0",) * n`` (the shards run in turn).
             benchmarks/mesh.py's five exactness rows, each bitwise the
             single-device server's answers: the stitched volumes, the
             fused top-3, every tenant on one shared clip (and dedup on
             == off), 4096-frame cursor streams (max_buffer_windows 8)
             and bf16 gratings.  ``metrics()["mesh"]`` must give each
             shape; per call B1 must not launch and B2 and B3 must launch
             data x model times the single device's count.  Printed per
             shape: batch latency (median of 7), peak device memory, the
             B2 / B3 / cuFFT device ms of one profiled call, the arena
             bytes one device holds, and benchmarks/mesh.py's
             per_device_work_x and arena_x (from the pool groups the
             server dispatched), beside the card's name and power limit.
             B2 on the inputs a shard launched it with, the (1, 2)
             mesh's widest shard and a (1, 4) shard whose tile is all
             zero (zero offsets both), is held bitwise against its plain
             version and timed (two ``kernel:`` rows).
12. lm_zamba — zamba2-2.7b at its published config (54 Mamba-2 layers,
             d_model 2560, state 64, 80 SSM heads; one shared attention
             block, width 5120, 32 heads of 160, applied at 9 sites;
             2.459 B parameters, bf16, random weights from a seeded
             generator on the card) served by ``LMServer.generate`` with
             a KV cache per site of prompt + new tokens, on the ``lm``
             batches, timed and profiled as there (device ms by kind:
             B5, B6, GEMMs, elementwise); B5's counter must read 54 and
             B6's 9 x the prefills run (decode launches neither).  On
             each batch's prompts, B5's (128, 64, 64) build is held
             against its plain version on layer 0's SSD operands as the
             model launches it (2 x 1000 padded to 2 x 1024; relative L2
             <= 1e-5; its passes' device ms from that batch's profiled
             prefill), and B6's head-dim-160 builds on the first site's
             q, k, v (S = 1000 unpadded; bf16: the ``lm_dense`` bounds;
             float32: relative L2 <= 1e-5, max abs <= 3e-5); and
             a one-site float32 model at full width (6 layers) must give
             the same last logits and decode step by the kernel and the
             plain routes (relative L2 <= 1e-4).
13. lm_moe — mixture-of-experts LM serving, one model at a time (each
             freed before the next is built; random weights from a
             seeded generator on the card): deepseek-v2-lite-16b at its
             published config (27 layers: MLA with kv_lora 512, one dense
             layer, 26 of 64 routed experts top-6 + 2 shared; 15.71 B
             parameters, bf16), then arctic-480b at its published widths
             (d_model 7168, 56 heads over 8 kv heads of 128, 128 experts
             top-2 beside a dense residual of 4864) with the depth cut
             from 35 to 2 layers (27.68 B parameters, bf16), each served
             by ``LMServer.generate`` on the ``lm`` batches, timed and
             profiled as there.  DeepSeek runs MLA's blockwise attention
             as the reference does (B6 and B5 0 launches); Arctic's
             prefill attention runs B6 (2 per prefill, decode none).
             Printed per model and batch: the prefill's model-FLOP share
             (active parameters only), decode ms/token against its floor
             (every weight read once at 3.35 TB/s: the dense dispatch
             reads every expert), the FLOPs of the dense dispatch and
             combine einsums, and one MoE layer's stages timed alone.
             Checks: finite logits; B6 on Arctic's layer-0 q, k, v of
             both batches (group 7; the ``lm_dense`` bf16 bounds, float32
             within 1e-5 / 3e-5); a one-layer float32 Arctic at full width
             with 8 experts gives the same last logits and decode step by
             the kernel and blockwise routes (1e-4), with routes that
             differ only on near ties (<= 1e-5 of the k-th probability);
             ``moe._topk_dispatch`` on the card bitwise the CPU's on
             (4, 2048, 64) and (2, 4096, 128) with exact ties planted.
14. lm_mm  — the audio and VLM families, one model at a time (random
             bf16 weights from a seeded generator on the card):
             whisper-tiny at its published config (4 + 4 layers, d_model
             384, 6 heads of 64, 1500 frames, 49.03 M parameters), its
             prompts a batch dict of tokens and (B, 1500, 384) frames,
             then internvl2-2b at its published config (24 layers,
             d_model 2048, 16 heads over 8 kv heads of 128, 1.889 B
             parameters), 256 patches of (B, 256, 2048) ahead of the
             tokens and its cache sized 256 + S + new; each served by
             ``LMServer.generate`` on the ``lm`` batches, timed and
             profiled as there, with the prefill's model-FLOP share (2 x
             the weights a position runs through).  B6 launches per
             prefill, gated: Whisper 12 (encoder, decoder self and cross
             attention at each of 4 layers, on the head-dim-64 build),
             InternVL2 24; decode and B5 none.  B6 is held against its
             plain version on layer 0's q, k, v of every site and batch
             (bf16: the ``lm_dense`` bounds; float32 within 1e-5 / 3e-5)
             and timed as a ``kernel:`` row beside SDPA; a one-layer
             float32 model of each at full width gives the same last
             logits and decode step by the kernel and blockwise routes
             (1e-4).
15. roofline — the op counter (``launch/op_analysis.py``) and the
             three-term roofline (``launch/roofline.py``) on the card:
             the qwen2-1.5b and mamba2-370m training steps (the
             ``lm_train`` recipe, 4 x 2048) and the qwen2-1.5b 4 x 2048
             prefill, each counted twice, on ``meta`` and around one real
             step on the card; the two counts must be equal in FLOPs, in
             bytes and per op name (gated: B5 and B6 count by their own
             formula whichever route runs them).  Each step is then timed
             with no counter (median of 5 after a warm-up) beside its
             roofline: measured ms, the bound and its term, bound /
             measured, FLOPs by class, the counter's temp bytes against
             ``max_memory_allocated`` less the arguments (reported, not
             gated), B5's and B6's forward and plain-backward buckets and
             the ops that move the most bytes.  Every kernel row's bound
             (phases kernels, lm*, classify, train, mesh) comes from
             ``op_analysis.kernel_cost`` on ``roofline``'s constants, but
             C3D's rows' (``c3d_cost``, the benchmark's yardstick).
16. lm_train — LM training through ``launch.train.train_loop`` on the
             card, one model at a time: qwen2-1.5b (28 layers, bf16, full
             remat, attention on B6) and mamba2-370m (48 layers, bf16,
             full remat, the SSD on B5) at their published configs, 8
             steps of 4 x 2048 tokens from the token stream, AdamW
             (float32 moments), saves off in the timed steps and one
             final save, kept for ``reshard``.  Each step timed between two synchronisations:
             median of steps 2-8, tokens/s, model-FLOP share (6 x
             params a token over 989 TFLOP/s), peak memory, the loss of
             steps 0 and 7 (step 0 finite and within 2.5 of ln V, gated;
             step 7 below step 0, gated), each kernel's launches per step
             (the same every step and never 0, gated: with full remat
             the forward and its recomputation each launch).  Then one
             more forward and backward: every parameter's gradient
             exists, is finite and is not all zero (gated); one profiled
             step (device ms by kind, busy share, the AdamW update's host
             ms); the kernel's ``kernel:`` row on layer 0's operands at
             the training shape; B5 and B6 relaunched on the same inputs
             bitwise (gated); ``ssd_ops.ssd(impl='kernel')`` on CUDA
             inputs that require grad has a ``grad_fn`` and autograd of
             the plain version's gradients (1e-5, gated).  Float32 gradients of the kernel routes
             (B6, B5) against the plain routes (blockwise, chunked) from
             the same weights and batch, every parameter within 1e-4
             relative L2 (gated): each family's smoke config (2 x 48;
             MoE and MLA at a capacity with no drops) and one
             full-width qwen2-1.5b layer at 1 x 512.  The restart
             contract: mamba2-370m at full width with 8 of its 48
             layers, 2 x 512, 12 steps, saves every 4, synchronous,
             under ``torch.use_deterministic_algorithms(True)``: killed
             at steps 5 and 9 under ``run_with_restarts``, its final
             parameters bitwise those of an uninterrupted run (gated;
             where an op has no deterministic CUDA version it is named
             and the runs are held within 1e-6); save and restore
             seconds.  Every line ends in the card's name and power
             limit.  Runs after every other phase but ``reshard``, so
             that no earlier phase runs in a changed process state.
17. reshard — the elastic re-mesh of training state: ``lm_train``'s
             final checkpoints of qwen2-1.5b and mamba2-370m (bf16
             params, float32 AdamW m and v, the step) restored by
             ``checkpoint.restore_resharded`` onto logical meshes of
             ``cuda:0``: (1, 4) and (2, 2) for mamba2-370m, (2, 2) for
             qwen2-1.5b (its (1, 4) restore is cut for time: the npz
             read runs at ~0.4 GB/s), each leaf a ``ShardedTensor`` under
             ``tree_shardings`` of ``specs.params_logical_axes`` and the
             training rules.  Gated: every leaf's ``full()`` bitwise the
             unsharded ``restore`` (moved to the card); each leaf one
             shard a mesh position, as many distinct tiles and of the
             shape its spec gives; the forward loss at 4 x 2048 from the
             gathered parameters bitwise the unsharded state's, B6 (or
             B5) launched once a layer and the other kernel never, the
             counts zeroed before the restore.  Restore seconds, the
             shards' device bytes and the peak host RSS (sampled from
             ``/proc/self/statm``); every line ends in the card's name and
             power limit.  The checkpoints are removed after it.
18. mesh_train — inside ``reshard``, on each model's last re-mesh, the
             (2, 2) state still held: training on a mesh through
             ``launch.train.mesh_step``.  First 3 one-device steps of 4 x
             2048 from the unsharded restore (consumed in place), 2
             microbatches of 2 x 2048; then 3 steps on the (2, 2) state,
             each data rank's 2 x 2048 rows one microbatch, and one more
             step under the profiler.  Gated: each step's loss within
             1e-3 of the one-device step's (bf16); every loss and grad
             norm finite; B6 (or B5) launched data x n_micro x a
             microbatch's (2 x layers, full remat) times a step, the
             other kernel never, the counts zeroed before the phase;
             one step's gradients on a (1, 4) mesh with n_micro 2 and
             ``grad_shardings``, every tile bitwise the one-device
             gradients' slice, and the loss bitwise (deterministic
             algorithms); the kernel's row at a rank's 2 x 2048 against
             its plain version; the granite-8b (for qwen2-1.5b) or
             mamba2-370m smoke config in float32 on a (2, 2) mesh within
             ``tests/test_torch_mesh_train.py``'s bounds.  Printed: step
             ms on the mesh and on one device, the device span (CUDA
             events) and busy ms (the profiled step's raw events) of
             the all-gathers, reduce-scatters and tile AdamW, the peak
             memory, the final parameters' worst rel L2 (bf16).
19. dryrun_mesh — the dry run on the reference's production meshes
             (``launch/dryrun.py --mesh single|multi``), counted on
             ``meta`` with no card: qwen2-1.5b and mamba2-370m
             ``train_4k`` on 16 x 16 and qwen2-1.5b ``prefill_32k`` on 2 x
             16 x 16, each cell in a process of its own (CUDA hidden
             from it), the three at once.  One line a cell: the compute,
             memory and collective terms (the collective priced on
             NVLink inside an 8-card node, NDR InfiniBand across), the
             argument + temp GB of one card, whether they fit in its 80
             GB, and the seconds the count took.  Gated: status ``ok``,
             finite positive compute and memory terms, a collective term
             above 0.

The last line is ``{"ok": true, "device": {...}}``; any failure raises
and exits non-zero.  Without CUDA, or outside a checkout of the repo, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.launch import op_analysis, roofline  # noqa: E402

# the card's constants (H100 SXM): one source, launch/roofline.py
HBM_BYTES_PER_S = roofline.HBM_BW
BF16_FLOPS = roofline.PEAK_FLOPS_BF16
SSD_RTOL = 1e-5
FLASH_BF16_RTOL = 1e-2  # the plain version rounds q·scale to bf16 before the dot
# B6 in bf16 against the plain version on the same inputs upcast to float32
# (no q·scale rounding, p not rounded): the kernel rounds each p (relative
# 2^-9) and each output (2^-9) to bf16, so a right row is off by about
# 2^-9 of its norm and no element by more than 2^-8·max|v| (3.9e-3);
# a wrong row (mask, kv head, stale tile) is off by O(1) of its norm,
# which the whole tensor's relative L2 dilutes to ~3e-3 at 98,304 rows
FLASH_BF16_ROW_RTOL = 1e-2  # worst row's relative L2
FLASH_BF16_ABS_V = 5e-3  # max abs error, in units of max|v|
FLASH_F32_RTOL, FLASH_F32_ATOL = 1e-5, 3e-5
# B6 bf16 sweep (B, Sq, Sk, H, G, D, causal): ragged lengths (37, 130,
# 1000, 1500: not multiples of the 64-row tile), Sq != Sk both ways, GQA
# groups H/G of 1, 2, 6 and 7 (arctic-480b's 56 over 8), head dims 16, 24
# (padded to 32 in shared memory), 32, 64 (whisper-tiny's, one 128-byte
# half), 128 and 160 (padded to 192), both mask settings
FLASH_BF16_SWEEP = (
    (2, 37, 37, 4, 4, 16, True), (2, 37, 37, 4, 2, 16, False),
    (1, 40, 100, 4, 2, 16, False), (1, 40, 100, 4, 2, 16, True),
    (2, 96, 96, 8, 4, 32, True), (2, 71, 71, 6, 1, 32, False), (1, 100, 40, 4, 2, 32, True),
    (2, 64, 64, 2, 2, 24, True), (2, 130, 130, 6, 1, 24, False),
    (1, 40, 100, 12, 2, 128, False), (1, 300, 300, 4, 4, 128, True),
    (2, 1000, 1000, 12, 2, 128, True), (2, 1000, 1000, 12, 2, 128, False),
    (2, 1000, 1000, 32, 32, 160, True), (2, 1000, 1000, 32, 32, 160, False),
    (1, 130, 130, 4, 2, 160, True), (1, 40, 100, 4, 4, 160, False),
    (1, 300, 300, 14, 2, 128, True), (2, 1000, 1000, 56, 8, 128, False),
    (1, 130, 130, 6, 6, 64, True), (2, 1500, 1500, 6, 6, 64, False),
    (1, 40, 100, 6, 3, 64, False), (1, 100, 40, 4, 2, 64, True), (2, 37, 1500, 6, 6, 64, False),
)
# B6 float32 (the FMA build) at D = 64: ragged causal, Sq < Sk with GQA,
# and a ragged cross shape over whisper-tiny's 1500 frames
FLASH_F32_D64 = (
    (1, 130, 130, 6, 6, 64, True), (1, 40, 100, 6, 3, 64, False), (2, 37, 1500, 6, 6, 64, False),
)
LM_RTOL = 1e-4
# routing of two float32 routes may differ only on a near tie: the gap in
# the router probabilities, relative to the k-th largest
NEAR_TIE_REL = 1e-5
# substrings of the hand-written kernels' names, listed in every profile
OWN_KERNELS = ("topk", "mac_", "ssd", "flash", "conv3d")
# Decode attention's bf16-GEMM route against the _dot_f32 route on
# the same tensors.  Each product's float32 output: the products are exact
# in float32 on both routes and only the sum order differs.  The whole
# bf16 output: p and the output are rounded to bf16 (2^-9 relative), so a
# sum-order difference can flip a rounding; a wrong head or layout is off
# by O(1)
DECODE_DOT_RTOL = 1e-5
DECODE_OUT_RTOL = 1e-2
MEM_STREAM_FRAMES = (4096, 8192)  # a cursor stream, then one twice as long
SERVE_REPS = 7  # timed calls per serving mode, after one warm-up
# timed calls per LM batch and kind, after one warm-up (3 since the
# roofline phase joined: the script must end well inside its time limit)
LM_REPS = 3
LM_BATCHES = ((4, 2048, 32), (2, 1000, 8))  # (prompts, prompt tokens, new tokens)
# the scheduler phase: open-loop rates as fractions of the pooled rung's
# frames/s, requests per rate (one 1024-frame stream each) and the client
# threads submitting them; results held against alone runs (max relative)
SCHED_RATES = (0.5, 0.9, 1.0, 1.2, 1.5)  # above 1.0 a rejection is a result
SCHED_PROFILE_RATE = 0.9  # the profiled replay
SCHED_REQUESTS = 96
SCHED_FRAMES = 1024
SCHED_CLIENTS = 6
SCHED_RTOL = 1e-5
SCHED_RESULT_TIMEOUT_S = 180
STORM_REQUESTS, STORM_FRAMES, STORM_SEED = 32, 256, 100
POISON_EVERY = 8  # every 8th storm clip carries NaNs
STORM_DRAIN_S = 10.0  # bound on the wait for the batcher to take the expired probe
BREAKER_RECOVERY_S = 0.15
# the replica phase: benchmarks/chaos.py's three replica rows at their
# request counts, paper-geometry replicas, 1024-frame clips; each replica
# warmed at every batch size its scheduler forms (max_batch 8, the default)
REPLICA_STORM_REQUESTS, REPLICA_HEDGE_REQUESTS, REPLICA_FLAP_REQUESTS = 60, 40, 48
REPLICA_FRAMES = 1024
REPLICA_WARM_ROWS = 8
REPLICA_AVAILABILITY_MIN = 95.0
CONV_RTOL, CONV_BF16_RTOL = 1e-5, 1e-2  # B4 vs its plain version, relative L2
STREAM_RTOL = 2e-4  # streamed digital vs ideal STHC conv (the reference test's bound)
TIE = 1e-4  # top-two logits this close (relative to their scale) may break either way
CLASSIFY_BATCH = 16  # clips per batch, as benchmarks/accuracy.py evaluates
CLASSIFY_REPS = 7  # timed batches per route, after one warm-up
C3D_BATCH = 128  # clips a C3D classify call: the benchmark cell c3d-clips sends 128
C3D_REPS = 3  # timed C3D classify calls, after one warm-up
STREAM_FRAMES = 512  # frames of each of the four long clips
# the training phase: the reference's recipe (benchmarks/accuracy.py) and
# its bounds: digital and spectral gradients of one step (relative L2),
# test accuracy on both (134 of 144 clips), every cumulative ablation
# stack, and the last logged loss (a quarter of ln 4)
TRAIN_BATCH, TRAIN_EPOCHS = 32, 45
TRAIN_GRAD_RTOL = 1e-4
TRAIN_ACC_MIN = 0.93
ABLATION_ACC_MIN = 0.90
TRAIN_LOSS_MAX = 0.35
# the reference conv3d test sweep's shapes (tests/test_kernels.py):
# (b, c, o, k, h, t) -> x (b, c, h, h+2, t), w (o, c, k, k, min(k, t))
CONV_SWEEP = (
    (1, 1, 1, 1, 6, 4), (2, 4, 6, 3, 14, 10), (1, 3, 2, 2, 9, 5), (2, 2, 5, 3, 7, 7),
    (1, 4, 3, 1, 12, 9), (2, 1, 4, 2, 11, 6), (1, 2, 6, 3, 8, 8), (2, 3, 1, 2, 13, 4),
)


def _time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in one CUDA
    graph, replayed and timed with CUDA events, so the host's cost of
    launching each call is not in it (it is in ``_time_ms`` when a call
    takes the device less time than the host takes to launch it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = _time_ms(graph.replay, 5) / reps
    del graph
    return ms


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _kernel_bound(name: str, peak: float | None = None, **shape) -> tuple[float, str]:
    """The least ms one call of kernel ``name`` at ``shape`` could take
    (``op_analysis.kernel_cost`` on ``roofline``'s constants; ``peak``
    overrides its class's peak FLOP/s) and whether bytes or operations
    bound it."""
    s, by = roofline.kernel_bound_s(op_analysis.kernel_cost(name, **shape), peak)
    return s * 1e3, by


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _cuda_tool(name: str) -> str | None:
    found = shutil.which(name)
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    return cand if os.path.exists(cand) else None


def _demangle(names: list[str]) -> dict[str, str]:
    tool = shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    lines = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else {n: n for n in names}


def _ptxas_by_function(log: str) -> list[dict]:
    """``-Xptxas -v``'s registers, spills and stack, per entry function."""
    funcs, cur, props = [], None, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"function": ln.split("'")[1]}
            funcs.append(cur)
        elif "Function properties for" in ln:
            props = ln.split("Function properties for")[1].strip()
        elif cur is not None and "spill stores" in ln and props == cur["function"]:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            cur["stack_bytes"], cur["spill_store_bytes"], cur["spill_load_bytes"] = nums[:3]
        elif cur is not None and (used := re.search(r"Used (\d+) registers", ln)):
            cur["registers"] = int(used.group(1))  # other lines may name registers (setmaxnreg notes)
    names = _demangle([f["function"] for f in funcs])
    for f in funcs:
        f["function"] = names[f["function"]]
    return funcs


def phase_build(libs: dict) -> dict:
    """Build every kernel library at once (one nvcc each, in parallel)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(libs)) as pool:
        futs = {name: pool.submit(mod.build) for name, mod in libs.items()}
        infos = {name: f.result() for name, f in futs.items()}
    report = {}
    for name, info in infos.items():
        funcs = _ptxas_by_function(info["log"])
        print(f"build: {name} {info['seconds']:.2f} s nvcc sm_90a -> {os.path.relpath(info['path'], ROOT)}")
        for f in funcs:
            print(
                f"build:   {f['function']}: {f.get('registers')} registers, "
                f"{f.get('spill_store_bytes')} bytes spill stores, "
                f"{f.get('spill_load_bytes')} bytes spill loads, {f.get('stack_bytes')} bytes stack"
            )
        warnings = [ln.strip() for ln in info["log"].splitlines() if "warning" in ln.lower()]
        for ln in warnings:
            print(f"build:   {ln}")
        report[name] = {"seconds": info["seconds"], "path": info["path"], "ptxas": funcs,
                        "warnings": warnings}
    return report


def _sass_counts(so_path: str, ops: tuple) -> dict | None:
    """Instructions of each kernel in a library's SASS (``cuobjdump``), by
    demangled name; None when the tool is missing."""
    tool = _cuda_tool("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            fn = ln.split("Function : ")[1].strip()
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in counts[fn]:
                if f" {op}" in ln:
                    counts[fn][op] += 1
    names = _demangle(list(counts))
    return {names[f]: c for f, c in counts.items()}


def check_ssd_build(ssd_kernel, so_path: str) -> dict | None:
    """B5's chunk-state and chunk-scan kernels, every instantiation of
    ``kernel.SHAPES``, issue tensor-core MMAs (HMMA, mma.sync) in their
    SASS; the scan kernel's operands arrive by cp.async (LDGSTS)."""
    counts = _sass_counts(so_path, ("HMMA", "LDGSTS", "FFMA"))
    if counts is None:
        print("build: ssd SASS: cuobjdump not found, instructions not counted")
        return None
    mma = {f: c for f, c in counts.items() if "ssd_state_kernel" in f or "ssd_scan_kernel" in f}
    for f, c in mma.items():
        print(f"build: ssd SASS {f}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    if len(mma) != 2 * len(ssd_kernel.SHAPES) or not all(c["HMMA"] for c in mma.values()) or not all(
        c["LDGSTS"] for f, c in mma.items() if "ssd_scan_kernel" in f
    ):
        raise AssertionError(f"the ssd builds lack tensor-core MMAs or cp.async: {mma}")
    return mma


def check_flash_build(flash_kernel, so_path: str) -> dict:
    """B6's builds as compiled: every (dtype, head dim)'s dynamic shared
    memory from the library equals ``kernel.smem_bytes`` and fits one
    block's 227 KB; in the SASS (``cuobjdump``), every bf16 build issues
    warpgroup tensor-core MMAs (HGMMA, wgmma) and asynchronous copies
    (LDGSTS, cp.async)."""
    plan = {}
    for dtype in flash_kernel.DTYPES:
        for d in flash_kernel.HEAD_DIMS:
            want, got = flash_kernel.smem_bytes(dtype, d), flash_kernel.smem_bytes_built(dtype, d)
            route = flash_kernel.ROUTES[(dtype, d)]
            print(f"build: flash ({str(dtype).removeprefix('torch.')}, D {d}) -> {route} kernel, "
                  f"{got} bytes dynamic shared memory")
            if got != want or not 0 < got <= flash_kernel.SMEM_PER_BLOCK:
                raise AssertionError(f"flash ({dtype}, {d}): library plans {got} bytes, kernel.py {want}")
            plan[f"{dtype}/{d}"] = {"route": route, "smem_bytes": got}
    counts = _sass_counts(so_path, ("HGMMA", "HMMA", "LDGSTS", "MUFU.EX2", "FFMA"))
    if counts is None:
        print("build: flash SASS: cuobjdump not found, instructions not counted")
        return {"plan": plan, "sass": None}
    wg = {f: c for f, c in counts.items() if "flash_wgmma_kernel" in f}
    for f, c in wg.items():
        print(f"build: flash SASS {f}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    if len(wg) != len(flash_kernel.HEAD_DIMS) or not all(c["HGMMA"] and c["LDGSTS"] for c in wg.values()):
        raise AssertionError(f"the bf16 flash builds lack wgmma or cp.async: {wg}")
    return {"plan": plan, "sass": wg}


def check_conv3d_build(so_path: str, warnings: list[str]) -> dict | None:
    """B4's tensor-core kernel issues warpgroup tensor-core MMAs (HGMMA,
    3xTF32 wgmma) and asynchronous copies (UTMALDG: TMA tensor-map loads
    of x; UBLKCP: bulk copies of B) in its SASS, its two implicit-GEMM
    kernels (BN 64 and 128) HGMMA and UTMALDG, and ptxas warned of no
    wgmma serialization for the library."""
    serial = [ln for ln in warnings if "wgmma" in ln and "serializ" in ln]
    if serial:
        raise AssertionError("ptxas serialized wgmma in the conv3d library:\n" + "\n".join(serial))
    counts = _sass_counts(so_path, ("HGMMA", "UTMALDG", "UBLKCP", "LDS", "FFMA"))
    if counts is None:
        print("build: conv3d SASS: cuobjdump not found, instructions not counted")
        return None
    tc = {f: c for f, c in counts.items() if "conv3d_tc_kernel" in f}
    for f, c in tc.items():
        print(f"build: conv3d SASS {f}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    if len(tc) != 1 or not all(c["HGMMA"] and c["UTMALDG"] and c["UBLKCP"] for c in tc.values()):
        raise AssertionError(f"the conv3d tensor-core kernel lacks wgmma or asynchronous copies: {tc}")
    ig = {f: c for f, c in counts.items() if "conv3d_igemm_kernel" in f}
    for f, c in ig.items():
        print(f"build: conv3d SASS {f}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    if len(ig) != 2 or not all(c["HGMMA"] and c["UTMALDG"] for c in ig.values()):
        raise AssertionError(f"the conv3d implicit-GEMM kernels (BN 64, 128) lack wgmma or TMA loads: {ig}")
    return tc | ig


def phase_kernels(kernel, ref, seed: int, launches: dict) -> list[dict]:
    """Each kernel vs its plain version at the serving path's shapes."""
    from repro_torch.core import spectral_conv

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    F = 90 * 120 * 37  # rfftn grid of a 64-frame window at 60x80, 30x40x8
    L = 4 * 31 * 41 * 57  # one readout launch: 4 windows x H' x W' x step
    O, C = 9, 1

    def cplx(*shape):
        return torch.complex(
            torch.randn(shape, generator=g, device=dev),
            torch.randn(shape, generator=g, device=dev),
        )

    rows = []

    def row(name, fn, plain, library, check, bound, launches_of, reps=20, graph=False):
        out = fn()
        exp = plain()
        err, ok = check(out, exp)
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version ({err})")
        timer = _graph_ms if graph else _time_ms
        ms = timer(fn, reps)
        plain_ms = _time_ms(plain, 3)
        lib_ms = timer(library, reps) if library is not None else None
        bound, by = bound
        r = {
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/stmul/csrc/stmul.cu",
            "replaces": launches_of[1],
            "launches": launches[launches_of[0]],
            "max_abs_err": err["max_abs_err"],
            "max_err": err["max_abs_err"],
            "rel_l2": err.get("rel_l2"),
            "ms": ms,
            "kernel_ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": lib_ms,
        }
        if graph:  # the same calls launched one by one, host time included
            r["host_ms"] = _time_ms(fn, reps)
            print(f"kernels: {name} {ms:.4f} ms on the device (CUDA graph of {reps} calls), "
                  f"{r['host_ms']:.4f} ms a call launched one by one")
        rows.append(r)
        del out, exp

    def mac_bits(out, exp):
        mx = float(torch.max(torch.abs(out - exp)))
        return {"max_abs_err": mx}, _bits_equal(torch.view_as_real(out), torch.view_as_real(exp))

    # B1: sequential rung, a tenant group of 2 streams x 4 windows per chunk
    x = cplx(8, C, F)
    gr = cplx(O, C, F)
    with spectral_conv.full_precision():
        for version, name in ((2, "spectral_mac"), (1, "spectral_mac[v1]")):
            row(
                name,
                lambda v=version: kernel.spectral_mac_cuda(x, gr, v),
                lambda v=version: ref.spectral_mac_ref(x, gr, v),
                lambda: torch.einsum("bcf,ocf->bof", x, gr),
                mac_bits,
                _kernel_bound("spectral_mac", B=8, O=O, C=C, F=F),
                ("spectral_mac", "src/repro/kernels/stmul/kernel.py:147"),
            )
    del x, gr

    # B1 off the rung's plan, bitwise: an odd F (scalar path), three
    # channels (the C > 1 kernel, even and odd F) and 20 kernels at C = 1
    # (registers, chunks of 9, 9 and 2)
    for B_, O_, C_, Fx in ((8, O, C, F - 1), (4, O, 3, 10_000), (4, O, 3, 10_001), (3, 20, 1, 10_001)):
        xx, gg = cplx(B_, C_, Fx), cplx(O_, C_, Fx)
        plan = kernel.mac_plan(B_, O_, C_, Fx)
        for version in (2, 1):
            err, ok = mac_bits(kernel.spectral_mac_cuda(xx, gg, version), ref.spectral_mac_ref(xx, gg, version))
            print(f"kernels: B1 v{version} x ({B_}, {C_}, {Fx}) grating ({O_}, {C_}, {Fx}), plan {plan}: "
                  f"{'bitwise' if ok else 'DIFFERS'}")
            if not ok:
                raise AssertionError(f"B1 v{version} at B={B_}, O={O_}, C={C_}, F={Fx} differs ({err})")
        del xx, gg

    # B2: pooled rung, 4 encoded streams x 4 windows against an 18-row
    # arena; then irregular, unsorted offsets into a 64-row arena, and an
    # odd F (rows that are not 16-byte aligned); bitwise in every case
    x = cplx(16, C, F)
    b2_cases = (
        ("", [0, 0, 9, 9] * 4, 18, F),
        (",irregular", [37, 3, 55, 12, 0, 41, 29, 8, 50, 19, 33, 1, 46, 24, 5, 14], 64, F),
        (",odd F", [0, 0, 9, 9] * 4, 18, F - 1),
    )
    for tag, offs, n_rows, Fx in b2_cases:
        xx = x if Fx == F else x[:, :, :Fx].contiguous()
        for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            pre = torch.randn((n_rows, C, Fx), generator=g, device=dev).to(dtype)
            pim = torch.randn((n_rows, C, Fx), generator=g, device=dev).to(dtype)
            sel = torch.complex(pre.float(), pim.float())[
                torch.as_tensor(offs, device=dev)[:, None] + torch.arange(O, device=dev)[None]
            ]
            with spectral_conv.full_precision():
                row(
                    f"spectral_mac_grouped[{dname}{tag}]",
                    lambda: kernel.spectral_mac_grouped_cuda(xx, pre, pim, offs, O),
                    lambda: ref.spectral_mac_grouped_ref(xx, pre, pim, offs, O),
                    lambda: torch.einsum("bcf,bocf->bof", xx, sel),
                    mac_bits,
                    _kernel_bound("spectral_mac_grouped", B=16, C=C, F=Fx, o_start=offs, n_out=O,
                                  itemsize=pre.element_size()),
                    ("spectral_mac_grouped", "src/repro/kernels/stmul/kernel.py:248"),
                )
            del pre, pim, sel
        del xx
    del x

    # B2 beyond the video rung's C = 1: three channels (x staged beside
    # the arena), nine kernels in two chunks of o rows, even and odd F
    for Fx in (10_000, 10_001):
        xx = cplx(4, 3, Fx)
        for dtype in (torch.float32, torch.bfloat16):
            pre = torch.randn((12, 3, Fx), generator=g, device=dev).to(dtype)
            pim = torch.randn((12, 3, Fx), generator=g, device=dev).to(dtype)
            err, ok = mac_bits(kernel.spectral_mac_grouped_cuda(xx, pre, pim, [3, 0, 3, 1], O),
                               ref.spectral_mac_grouped_ref(xx, pre, pim, [3, 0, 3, 1], O))
            print(f"kernels: B2 x (4, 3, {Fx}) {dtype} against a 12-row arena, 9 outputs: "
                  f"{'bitwise' if ok else 'DIFFERS'}")
            if not ok:
                raise AssertionError(f"B2 at C = 3, F = {Fx}, {dtype} differs ({err})")

    # B3: pooled readout of 4 streams x 9 kernels; rows with NaN, -inf,
    # exact ties and signed zeros
    R = 4 * O
    vals = torch.randn((R, L), generator=g, device=dev)
    vals[:, 1::7] = vals[:, 0::7][:, : vals[:, 1::7].shape[1]]  # ties
    vals[1, 123] = float("nan")
    vals[2, :] = float("-inf")
    vals[2, 5:8] = torch.tensor([1.0, float("-inf"), 1.0], device=dev)
    vals[3, :] = 0.0
    vals[3, 10::3] = -0.0
    vals[4, 1000:] = float("-inf")
    gidx = torch.randperm(L, generator=g, device=dev).to(torch.int32)
    vals_tiefree = torch.randperm(R * L, generator=g, device=dev).float().reshape(R, L)

    def topk_check(out, exp):
        s_ok = _bits_equal(out[0], exp[0])
        i_ok = torch.equal(out[1], exp[1])
        both = torch.isfinite(out[0]) & torch.isfinite(exp[0])
        mx = float(torch.max(torch.abs(out[0][both] - exp[0][both]))) if both.any() else 0.0
        return {"max_abs_err": mx}, s_ok and i_ok

    # the pooled rung's 36 rows at k = 1 and 3, the sequential rung's 9
    # (one stream's group) and 18 (two streams) at k = 1
    for R_, k in ((R, 1), (R, 3), (9, 1), (18, 1)):
        v = vals[:R_]
        row(
            f"topk_readout[k={k}]" if R_ == R else f"topk_readout[k={k},R={R_}]",
            lambda k=k, v=v: kernel.topk_readout_cuda(v, gidx, k),
            lambda k=k, v=v: ref.topk_readout_ref(v, gidx, k),
            lambda k=k, R_=R_: torch.topk(vals_tiefree[:R_], k, dim=-1),
            topk_check,
            _kernel_bound("topk_readout", R=R_, L=L, k=k),
            ("topk_readout", "src/repro/kernels/stmul/kernel.py:434"), graph=True,
        )
    # tie runs, NaN and -inf stretches and signed zeros on the slice
    # boundaries the host plan picks, bitwise against the plain version,
    # and every other list width K (k = 2, 8, 16, 32) on six of the rows
    for R_, k in ((R, 1), (R, 3), (9, 1), (18, 1), (6, 2), (6, 8), (6, 16), (6, 32)):
        v = _straddling_scores(kernel.topk_plan(R_, L), R_, L, g)
        out = kernel.topk_readout_cuda(v, gidx, k)
        err, ok = topk_check(out, ref.topk_readout_ref(v, gidx, k))
        print(f"kernels: B3 ({R_}, {L}) k={k} with ties, NaN, -inf and +-0 on the "
              f"{kernel.topk_plan(R_, L)} slice boundaries: {'bitwise' if ok else 'DIFFERS'}")
        if not ok:
            raise AssertionError(f"B3 ({R_}, {L}) k={k} differs on slice boundaries ({err})")
        del v, out
    torch.cuda.synchronize()
    return rows


def _straddling_scores(plan, R, L, g) -> torch.Tensor:
    """(R, L) random scores with, around one slice boundary of ``plan``
    per row (rows take the boundaries in turn): a run of equal maxima
    across it, NaN just after or just before it, a row of -inf with two
    finite scores across it, a run of +0 / -0 maxima across it, and a
    -inf stretch across it with equal maxima at both ends."""
    S, n = plan
    v = torch.randn((R, L), generator=g, device="cuda")
    cuts = [s * n for s in range(1, S)] or [L // 2]
    for r in range(R):
        c = cuts[r % len(cuts)]
        kind = r % 6
        if kind == 0:
            v[r, max(c - 3, 0) : c + 3] = 10.0
        elif kind == 1:
            v[r, c] = float("nan")
        elif kind == 2:
            v[r, c - 1] = float("nan")
        elif kind == 3:
            v[r] = float("-inf")
            v[r, c - 1] = v[r, min(c + 1, L - 1)] = 1.0
        elif kind == 4:
            v[r] = -1.0 - torch.abs(v[r])
            v[r, max(c - 2, 0) : c + 2] = torch.tensor([0.0, -0.0, 0.0, -0.0], device="cuda")[
                : min(c + 2, L) - max(c - 2, 0)]
        else:
            lo, hi = max(c - 5000, 1), min(c + 5000, L - 1)
            v[r, lo:hi] = float("-inf")
            v[r, lo - 1] = v[r, hi] = 9.0
    return v


def _profile(fn) -> dict:
    """Wall time of one call, the device time of the kernels it ran (by
    name, from the profiler's CUDA events) and the device's busy share.
    Kernels on one stream do not overlap, so their sum is busy time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _device_time(prof, wall_ms, 1)


def _b5_passes(prof: dict, calls: int) -> dict:
    """B5's passes, device ms per wrapper call, from a ``_profile`` of
    ``calls`` calls (a profiled prefill makes one per Mamba-2 layer)."""
    return {
        n.split("namespace)::")[-1].split("(")[0]: ms / calls
        for n, ms in prof["by_name_ms"].items() if "ssd_" in n
    }


def _device_events(prof) -> list[tuple[str, int, int, bool]]:
    """(name, start ns, duration ns, is a ``record_function`` range) of
    each device event that a finished profile holds, step markers
    included, named as ``prof.events()`` names them.  Read from the profiler's raw
    results: ``prof.events()`` builds a tree of every host op first, at
    ~70 us an event on the host, which is tens of seconds for a profiled
    generate."""
    from torch.autograd import DeviceType

    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is None:
        return [(e.name, int(e.time_range.start * 1e3), int(e.time_range.elapsed_us() * 1e3),
                 getattr(e, "is_user_annotation", False))
                for e in prof.events() if e.device_type == DeviceType.CUDA]
    try:
        from torch.autograd.profiler_util import _rewrite_name
    except ImportError:
        def _rewrite_name(name, with_wildcard=False):
            return name
    return [
        (_rewrite_name(e.name(), with_wildcard=True), e.start_ns(), e.duration_ns(),
         e.is_user_annotation() if hasattr(e, "is_user_annotation") else False)
        for e in raw.events()
        if e.device_type() == DeviceType.CUDA
        and not (hasattr(e, "is_hidden_event") and e.is_hidden_event())
    ]


def _device_time(prof, wall_ms: float, calls: int) -> dict:
    """Per call: the device time of the kernels a profile holds, by name,
    their sum (busy time) and its share of ``wall_ms``.  The step markers
    a profiler schedule adds and the ranges ``record_function`` marks are
    not kernels."""
    by_name: dict[str, float] = {}
    for name, _, dur_ns, annotation in _device_events(prof):
        if not name.startswith("ProfilerStep") and not annotation:
            by_name[name] = by_name.get(name, 0.0) + dur_ns / 1e6 / calls
    busy_ms = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    # the eight longest, then every kernel of this repository's own
    top = ranked[:8] + [kv for kv in ranked[8:] if any(m in kv[0] for m in OWN_KERNELS)]
    return {
        "wall_ms": wall_ms,
        "device_ms": busy_ms if by_name else None,
        "busy_share": busy_ms / wall_ms if by_name else None,
        "top_kernels_ms": [(n[:80], ms) for n, ms in top],
        "by_name_ms": by_name,
    }


def _tenants(rng):
    """The four paper-geometry tenants: two ideal, one physical, one
    SLM-quantized, each 9 kernels of 30x40x8."""
    from repro_torch.core import fidelity as fid

    ks = [rng.randn(9, 1, 30, 40, 8).astype(np.float32) for _ in range(4)]
    pipes = (fid.ideal(), fid.ideal(), fid.physical(), fid.pipeline(fid.SLMQuantize()))
    return [(name, k, pipe) for name, k, pipe in zip("ABCD", ks, pipes)]


def _requests(rng):
    clips = [rng.rand(1, 1, 60, 80, 1024).astype(np.float32) for _ in range(5)]
    # request 2 shares request 1's clip (clip-dedup); C and D stack two
    # streams each
    return [
        ("A", clips[0]), ("B", clips[0]), ("C", clips[1]),
        ("C", clips[2]), ("D", clips[3]), ("D", clips[4]),
    ]


def _server(tenants, **cfg):
    from repro_torch.launch.serve import VideoSearchConfig, VideoSearchServer

    server = VideoSearchServer(
        frame_hw=(60, 80),
        cfg=VideoSearchConfig(window_frames=64, chunk_windows=4, use_pallas=True, **cfg),
    )
    for name, k, pipe in tenants:
        server.add_tenant(name, k, fidelity=pipe)
    return server


def _run(server, reqs, **kw):
    """One warm-up call, then ``SERVE_REPS`` timed calls of the batch.
    Returns the first timed output and the latencies (s); every call
    must answer every request, finite, and bitwise like the first."""
    server.search_batch(reqs, **kw)  # warm: cuFFT plans, allocator
    torch.cuda.synchronize()
    out, lat = None, []
    for _ in range(SERVE_REPS):
        t0 = time.perf_counter()
        res = server.search_batch(reqs, **kw)
        lat.append(time.perf_counter() - t0)
        for r in res:
            if not isinstance(r, dict):
                raise AssertionError(f"request failed: {r!r}")
            if r["scores"].shape != (1, 9) or not np.isfinite(r["scores"]).all():
                raise AssertionError(f"bad scores {r['scores']!r}")
        if out is None:
            out = res
        elif not all(np.array_equal(a["scores"], b["scores"]) for a, b in zip(out, res)):
            raise AssertionError("a repeated batch answered differently")
    return out, lat


def _mode_report(name, lat, frames, delta, extra="") -> dict:
    med = float(np.median(lat))
    print(
        f"serve: {name:11s} median {med * 1e3:8.2f} ms (min {min(lat) * 1e3:.2f}, "
        f"max {max(lat) * 1e3:.2f}, n={len(lat)})  {frames / med:10.1f} frames/s  "
        f"launches {delta}{extra}"
    )
    return {"latency_s": lat, "median_s": med, "frames_per_s": frames / med, "launches": delta}


def _launch_counts(kernel) -> dict:
    """B1's, B2's and B3's launch counters, by kernel name."""
    fns = (kernel.spectral_mac_cuda, kernel.spectral_mac_grouped_cuda, kernel.topk_readout_cuda)
    return {f.__name__.removesuffix("_cuda"): f.launches for f in fns}


def _max_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want) / np.abs(want)))


def phase_serve(kernel, seed: int) -> dict:
    from repro_torch.core import spectral_conv
    from repro_torch.core.engine import clip_keys_for

    rng = np.random.RandomState(seed)
    tenants = _tenants(rng)
    ks = [k for _, k, _ in tenants]
    reqs = _requests(rng)
    frames = sum(c.shape[0] * c.shape[-1] for _, c in reqs)
    server = _server(tenants)
    report = {"modes": {}}
    kernel.reset_launches()
    modes = [
        ("pooled", server, {}, ("spectral_mac_grouped", "topk_readout")),
        ("sequential", server, {"pooled": False}, ("spectral_mac", "topk_readout")),
        ("stitched", server, {"return_volume": True}, ("spectral_mac_grouped",)),
    ]
    outs = {}
    for name, srv, kw, need in modes:
        before = _launch_counts(kernel)
        outs[name], lat = _run(srv, reqs, **kw)
        after = _launch_counts(kernel)
        delta = {k: after[k] - before[k] for k in after}
        for k in need:
            if delta[k] <= 0:
                raise AssertionError(f"{name}: kernel {k} was not launched")
        report["modes"][name] = _mode_report(name, lat, frames, delta)
    # fused (pooled) == stitched amax / argmax, bitwise
    for a, b in zip(outs["pooled"], outs["stitched"]):
        if not (np.array_equal(a["scores"].view(np.int32), b["scores"].view(np.int32))
                and np.array_equal(a["peak_frame"], b["peak_frame"])):
            raise AssertionError(f"fused != stitched for tenant {a['tenant']}")
        vol = b["volume"].reshape(1, 9, -1)
        if not (torch.equal(torch.amax(vol, -1).cpu(), torch.from_numpy(b["scores"]))):
            raise AssertionError("stitched scores are not the volume's amax")
    pooled_vs_seq = max(
        _max_rel(a["scores"], b["scores"]) for a, b in zip(outs["pooled"], outs["sequential"])
    )
    if pooled_vs_seq > 1e-5:
        raise AssertionError(f"pooled vs sequential scores differ by {pooled_vs_seq:.3g}")
    report["pooled_vs_sequential_max_rel"] = pooled_vs_seq
    print(f"serve: fused == stitched bitwise; pooled vs sequential max rel {pooled_vs_seq:.3g}")
    del outs["stitched"]

    # where the time goes: host-side clip hashing (the dedup key), then a
    # profiled call of each rung
    t0 = time.perf_counter()
    clip_keys_for([c for _, c in reqs])
    report["host_clip_hash_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"profile: host clip hashing (dedup keys) {report['host_clip_hash_ms']:.2f} ms")
    for name, kw in (("pooled", {}), ("sequential", {"pooled": False})):
        prof = _profile(lambda kw=kw: server.search_batch(reqs, **kw))
        report["modes"][name]["profile"] = prof
        if prof["busy_share"] is None:
            busy = "not measured"
        else:
            busy = f"{prof['device_ms']:.2f} ms ({prof['busy_share']:.1%})"
        print(f"profile: {name:10s} wall {prof['wall_ms']:.2f} ms, device busy {busy}")
        for kname, ms in prof["top_kernels_ms"]:
            print(f"profile:   {ms:9.3f} ms  {kname}")

    report["pinned_vs_pageable"] = _pinned_vs_pageable(server, reqs)

    bf16 = _server(tenants, grating_dtype="bfloat16")
    before = _launch_counts(kernel)
    out_bf, lat = _run(bf16, reqs)
    after = _launch_counts(kernel)
    delta = {k: after[k] - before[k] for k in after}
    for k in ("spectral_mac_grouped", "topk_readout"):
        if delta[k] <= 0:
            raise AssertionError(f"bf16 pooled: kernel {k} was not launched")
    bf_rel = max(
        _max_rel(a["scores"], b["scores"]) for a, b in zip(out_bf, outs["pooled"])
    )
    if bf_rel > 2e-2:
        raise AssertionError(f"bf16 scores off the f32 ones by {bf_rel:.3g}")
    report["modes"]["pooled_bf16"] = _mode_report(
        "pooled_bf16", lat, frames, delta, f"  max rel vs f32 {bf_rel:.3g}"
    )
    report["modes"]["pooled_bf16"]["max_rel_vs_f32"] = bf_rel
    report["launches"] = _launch_counts(kernel)

    # correctness against direct correlation on a short clip (ideal tenant)
    short = rng.rand(1, 1, 60, 80, 128).astype(np.float32)
    got = server.search(short, tenant="A")
    direct = spectral_conv.direct_correlate3d(
        torch.from_numpy(short).cuda(), torch.from_numpy(ks[0]).cuda()
    ).reshape(1, 9, -1)
    want = torch.amax(direct, -1).cpu().numpy()
    rel = float(np.max(np.abs(got["scores"] - want) / np.abs(want)))
    if rel > 1e-4:
        raise AssertionError(f"ideal scores off direct correlation by {rel:.3g}")
    report["ideal_vs_direct_max_rel"] = rel
    print(f"serve: ideal tenant vs direct conv3d max rel {rel:.3g}")
    report["cursor_memory"] = _cursor_memory(tenants, server, rng)
    report["frames_per_request"] = 1024
    return report


def _pinned_vs_pageable(server, reqs) -> dict:
    """The video rungs' host clips staged through pinned memory (the
    server's ``staged_to_device``) against the pageable copy it replaced
    (``as_tensor``), in alternating turns: ``SERVE_REPS`` calls of each on
    each rung, then one profiled call of each for the host-to-device
    copies' device ms."""
    from repro_torch.core.engine import as_tensor
    from repro_torch.launch import serve as serve_mod

    staged = serve_mod.staged_to_device
    copy_fns = {"pinned": staged, "pageable": as_tensor}
    out = {}
    try:
        for name, kw in (("pooled", {}), ("sequential", {"pooled": False})):
            lat = {"pinned": [], "pageable": []}
            for i in range(SERVE_REPS):
                for kind in ("pageable", "pinned") if i % 2 == 0 else ("pinned", "pageable"):
                    serve_mod.staged_to_device = copy_fns[kind]
                    t0 = time.perf_counter()
                    server.search_batch(reqs, **kw)
                    lat[kind].append(time.perf_counter() - t0)
            copy_ms = {}
            for kind in ("pinned", "pageable"):
                serve_mod.staged_to_device = copy_fns[kind]
                prof = _profile(lambda kw=kw: server.search_batch(reqs, **kw))
                copy_ms[kind] = sum(ms for k, ms in prof["by_name_ms"].items() if "Memcpy HtoD" in k)
            meds = {k: float(np.median(v)) * 1e3 for k, v in lat.items()}
            out[name] = {"median_ms": meds, "latency_s": lat, "htod_copy_device_ms": copy_ms}
            print(f"serve: {name:10s} clips pinned median {meds['pinned']:.2f} ms vs pageable "
                  f"{meds['pageable']:.2f} ms (n={SERVE_REPS} each, in turns); host-to-device copies "
                  f"{copy_ms['pinned']:.3f} vs {copy_ms['pageable']:.3f} ms device time")
    finally:
        serve_mod.staged_to_device = staged
    return out


def _cursor_memory(tenants, unbounded, rng) -> dict:
    """Host residency of cursor streams: a ``max_buffer_windows = 8``
    pooled search (an ideal and a physical tenant on one numpy stream)
    keeps the stream on the host, so its peak device memory must not grow
    by a quarter of the stream's bytes when the stream doubles; its
    detections must equal the unbounded server's bitwise."""
    bounded = _server(tenants, max_buffer_windows=8)
    warm = rng.rand(1, 1, 60, 80, 1024).astype(np.float32)
    bounded.search_batch([("A", warm), ("C", warm)])  # record, plan, pool
    unbounded.search_batch([("A", warm), ("C", warm)])
    peaks, out = {}, {}
    for T in MEM_STREAM_FRAMES:
        clip = rng.rand(1, 1, 60, 80, T).astype(np.float32)
        reqs = [("A", clip), ("C", clip)]
        for name, srv in (("bounded", bounded), ("unbounded", unbounded)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = srv.search_batch(reqs)
            torch.cuda.synchronize()
            peaks[f"{name}_{T}"] = torch.cuda.max_memory_allocated()
            out[name] = res
        for a, b in zip(out["bounded"], out["unbounded"]):
            if not (np.array_equal(a["scores"].view(np.int32), b["scores"].view(np.int32))
                    and np.array_equal(a["peak_frame"], b["peak_frame"])):
                raise AssertionError(f"cursor detections at {T} frames differ from the unbounded call")
        print(f"serve: cursor {T}-frame numpy stream, max_buffer_windows 8: peak device memory "
              f"{peaks[f'bounded_{T}'] / 2**20:.1f} MiB (unbounded {peaks[f'unbounded_{T}'] / 2**20:.1f} "
              f"MiB); detections equal the unbounded call's bitwise")
        del clip, reqs, out["bounded"], out["unbounded"]
    t0, t1 = MEM_STREAM_FRAMES
    grew = peaks[f"bounded_{t1}"] - peaks[f"bounded_{t0}"]
    limit = 60 * 80 * t0 * 4 / 4  # a quarter of the shorter stream's bytes
    print(f"serve: cursor peak grew by {grew / 2**20:.2f} MiB from {t0} to {t1} frames "
          f"(limit {limit / 2**20:.2f} MiB)")
    if not grew < limit:
        raise AssertionError(f"cursor peak memory grew by {grew} bytes (limit {limit:.0f})")
    return {"peak_bytes": peaks, "growth_bytes": grew, "limit_bytes": limit}


def _check_alone(server, req, out, what: str) -> float:
    """Hold a scheduled result against the same request served alone by
    ``search_batch([req])``: scores within ``SCHED_RTOL`` (max relative);
    peak frames equal except where the alone run's volume holds, at the
    scheduled frame, a score within ``SCHED_RTOL`` of its peak (a tie).
    Returns the max relative score error."""
    (alone,) = server.search_batch([req])
    if not isinstance(alone, dict):
        raise AssertionError(f"{what}: the alone run failed: {alone!r}")
    rel = _max_rel(out["scores"], alone["scores"])
    if not rel <= SCHED_RTOL:
        raise AssertionError(f"{what}: scores off the alone run by {rel:.3g}")
    diff = np.argwhere(out["peak_frame"] != alone["peak_frame"])
    if len(diff):
        (vol,) = server.search_batch([req], return_volume=True)
        v = vol["volume"]
        for b, o in diff:
            at = float(v[b, o, ..., int(out["peak_frame"][b, o])].max())
            if not at >= float(alone["scores"][b, o]) * (1 - SCHED_RTOL):
                raise AssertionError(f"{what}: peak frame differs without a tie at ({b}, {o})")
    return rel


def _open_loop(sched, reqs, due, clients: int) -> dict:
    """Submit ``reqs[i]`` at ``due[i]`` seconds from the start, from a pool
    of ``clients`` threads (each submit hashes its clip), then wait for
    every future.  Returns per-request lag (actual minus scheduled submit
    start), submit-call ms, the outputs (None when shed) and the wall time
    from the first submit to the last result."""
    from repro_torch.launch.resilience import RequestRejected

    n = len(reqs)
    lag, submit_ms, futs, submitted = [None] * n, [None] * n, [None] * n, [None] * n
    t0 = time.perf_counter()

    def client(i):
        start = time.perf_counter()
        lag[i] = start - (t0 + due[i])
        try:
            futs[i] = sched.submit(*reqs[i])
        except RequestRejected:
            return
        submitted[i] = time.perf_counter()
        submit_ms[i] = (submitted[i] - start) * 1e3

    with ThreadPoolExecutor(clients) as pool:
        jobs = []
        for i in range(n):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            jobs.append(pool.submit(client, i))
        for j in jobs:
            j.result()
    first = t0 + due[0] + lag[0]
    outs = [None if f is None else f.result(timeout=SCHED_RESULT_TIMEOUT_S) for f in futs]
    return {
        "wall_s": time.perf_counter() - first,
        "lag_s": lag,
        "submit_ms": [x for x in submit_ms if x is not None],
        "submit_ms_by_request": submit_ms,
        "submitted_at": submitted,
        "outs": outs,
    }


def _sched_requests(frac: float, pooled_fps: float, seed: int):
    """Seeded Poisson arrivals at ``frac`` of the pooled rung's frames/s:
    ``SCHED_REQUESTS`` 1024-frame single-stream requests, tenants
    uniform, every third request repeating the previous one's clip.
    Returns the requests, their due times (s) and the rate (req/s)."""
    gen = np.random.default_rng([seed, int(frac * 100)])
    rate = frac * pooled_fps / SCHED_FRAMES  # requests per second
    due = np.cumsum(gen.exponential(1.0 / rate, SCHED_REQUESTS))
    due -= due[0]
    reqs = []
    for i in range(SCHED_REQUESTS):
        tenant = "ABCD"[int(gen.integers(4))]
        if i % 3 == 2:
            clip = reqs[-1][1]
        else:
            clip = gen.random((1, 1, 60, 80, SCHED_FRAMES), dtype=np.float32)
        reqs.append((tenant, clip))
    return reqs, due, rate


def _sched_rate(server, kernel, frac: float, pooled_fps: float, seed: int) -> dict:
    """Open-loop load at ``frac`` of the pooled rung's frames/s
    (``_sched_requests``); every future must resolve."""
    from repro_torch.launch.serve import MicrobatchScheduler

    reqs, due, rate = _sched_requests(frac, pooled_fps, seed)
    kernel.reset_launches()
    with MicrobatchScheduler(server, max_queue=64, max_batch=6, batch_wait_s=0.005) as sched:
        run = _open_loop(sched, reqs, due, SCHED_CLIENTS)
        m = sched.metrics()
    launches = _launch_counts(kernel)
    outs = run["outs"]
    for i, out in enumerate(outs):
        if out is not None and not (isinstance(out, dict) and np.isfinite(out["scores"]).all()):
            raise AssertionError(f"sched {frac}x: request {i} resolved badly: {out!r}")
    served = [i for i, o in enumerate(outs) if o is not None]
    if m["completed"] != len(served) or m["failed"] != 0:
        raise AssertionError(f"sched {frac}x: completed {m['completed']}, failed {m['failed']}, "
                             f"results {len(served)}")
    if frac <= 0.5 and (m["rejected"] or m["failed"]):
        raise AssertionError(f"sched {frac}x: {m['rejected']} rejected, {m['failed']} failed")
    for k in ("spectral_mac_grouped", "topk_readout"):
        if launches[k] <= 0:
            raise AssertionError(f"sched {frac}x: kernel {k} was not launched")
    if m["ladder"]["breakers"]["pooled"]["trips"] == 0 and launches["spectral_mac"] != 0:
        raise AssertionError(f"sched {frac}x: B1 launched {launches['spectral_mac']} times "
                             "on the pooled rung")
    lag = np.asarray(run["lag_s"]) * 1e3
    fps = len(served) * SCHED_FRAMES / run["wall_s"]
    rel = max(_check_alone(server, reqs[i], outs[i], f"sched {frac}x request {i}") for i in served)
    row = {
        "rate_frac": frac,
        "rate_rps": rate,
        "requests": SCHED_REQUESTS,
        "served": len(served),
        "latency_p50_ms": m["latency_p50_ms"],
        "latency_p90_ms": m["latency_p90_ms"],
        "latency_p99_ms": m["latency_p99_ms"],
        "frames_per_s": fps,
        "wall_s": run["wall_s"],
        "mean_batch_size": m["mean_batch_size"],
        "batches": m["batches"],
        "dedup_grouped": m["dedup_grouped"],
        "rejected": m["rejected"],
        "failed": m["failed"],
        "submit_ms_median": float(np.median(run["submit_ms"])),
        "lag_ms_median": float(np.median(lag)),
        "lag_ms_max": float(lag.max()),
        "launches": launches,
        "max_rel_vs_alone": rel,
    }
    print(
        f"sched: {frac}x pooled rate ({rate:.2f} req/s, {SCHED_REQUESTS} x {SCHED_FRAMES} frames, "
        f"{SCHED_CLIENTS} clients): latency p50 {row['latency_p50_ms']:.2f} p90 "
        f"{row['latency_p90_ms']:.2f} p99 {row['latency_p99_ms']:.2f} ms, delivered "
        f"{fps:.1f} frames/s, mean batch {row['mean_batch_size']:.2f} ({row['batches']} batches), "
        f"dedup_grouped {row['dedup_grouped']}, rejected {row['rejected']}, failed {row['failed']}"
    )
    print(
        f"sched: {frac}x submit (SHA-1 + enqueue) median {row['submit_ms_median']:.2f} ms, "
        f"lag behind schedule median {row['lag_ms_median']:.2f} ms max {row['lag_ms_max']:.2f} ms; "
        f"launches {launches}; scores vs alone max rel {rel:.3g}"
    )
    return row


def _sched_profile(server, pooled_fps: float, seed: int) -> dict:
    """One ``torch.profiler`` capture of the 0.9x replay: where a
    scheduled request's time goes.  Per request, on the host clock: SHA-1
    and enqueue at submit (in the client thread), the queue wait from the
    end of submit to the start of its batch's server call, and that call's
    wall time; per batch, the device busy ms of the profiler's kernels.
    The profiler's own cost inflates the host parts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import MicrobatchScheduler

    reqs, due, _ = _sched_requests(SCHED_PROFILE_RATE, pooled_fps, seed)
    search_batch = server.search_batch

    def timed(requests, **kw):  # stamps each result with its batch call
        t0 = time.perf_counter()
        outs = search_batch(requests, **kw)
        t1 = time.perf_counter()
        for o in outs:
            if isinstance(o, dict):
                o["batch_call_s"] = (t0, t1)
        return outs

    server.search_batch = timed
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with MicrobatchScheduler(server, max_queue=64, max_batch=6, batch_wait_s=0.005) as sched:
                run = _open_loop(sched, reqs, due, SCHED_CLIENTS)
                m = sched.metrics()
            torch.cuda.synchronize()
    finally:
        del server.search_batch  # the class's method again
    served = [i for i, o in enumerate(run["outs"]) if o is not None]
    sha1 = np.array([run["submit_ms_by_request"][i] for i in served])
    wait = np.array([(run["outs"][i]["batch_call_s"][0] - run["submitted_at"][i]) * 1e3 for i in served])
    call = np.array([(run["outs"][i]["batch_call_s"][1] - run["outs"][i]["batch_call_s"][0]) * 1e3
                     for i in served])
    total = np.array([run["outs"][i]["queue_latency_s"] * 1e3 for i in served]) + sha1
    dev = _device_time(prof, run["wall_s"] * 1e3, 1)
    per_batch = dev["device_ms"] / m["batches"] if dev["device_ms"] else None
    row = {
        "rate_frac": SCHED_PROFILE_RATE,
        "served": len(served),
        "batches": m["batches"],
        "sha1_submit_ms": {"median": float(np.median(sha1)), "mean": float(sha1.mean())},
        "queue_wait_ms": {"median": float(np.median(wait)), "mean": float(wait.mean())},
        "batch_call_ms": {"median": float(np.median(call)), "mean": float(call.mean())},
        "request_total_ms": {"median": float(np.median(total)), "p99": float(np.percentile(total, 99))},
        "device_busy_ms_per_batch": per_batch,
        "device_busy_share": dev["busy_share"],
        "top_kernels_ms": dev["top_kernels_ms"],
    }
    busy = "not measured" if per_batch is None else f"{per_batch:.2f} ms per batch ({dev['busy_share']:.1%} of the replay)"
    print(
        f"sched: profile {SCHED_PROFILE_RATE}x ({len(served)} requests, {m['batches']} batches, under "
        f"torch.profiler): per request median SHA-1 + enqueue at submit {row['sha1_submit_ms']['median']:.2f} "
        f"ms, queue wait {row['queue_wait_ms']['median']:.2f} ms, batch call "
        f"{row['batch_call_ms']['median']:.2f} ms, submit to result {row['request_total_ms']['median']:.2f} "
        f"ms (p99 {row['request_total_ms']['p99']:.2f}); device busy {busy}; kernels below: device ms "
        f"summed over the replay"
    )
    for kname, ms in dev["top_kernels_ms"]:
        print(f"profile:   {ms:9.3f} ms  {kname}")
    return row


def _storm(tenants, kernel) -> dict:
    """The reference's chaos storm on the port: stochastic dispatch faults,
    cache-fetch latency and forced evictions, encode latency and a tenant
    churning beside the traffic; every 8th clip NaN-poisoned."""
    from repro_torch.core import fidelity as fid
    from repro_torch.distributed.fault import ChaosInjector, ChaosRule
    from repro_torch.launch.resilience import (
        DeadlineExceeded, DegradationLadder, RetryPolicy, ServingError, TenantQuarantined,
    )
    from repro_torch.launch.serve import MicrobatchScheduler

    server = _server(tenants, verify_gratings=True)
    gen = np.random.default_rng(STORM_SEED)
    reqs = []
    for i in range(STORM_REQUESTS):
        clip = gen.random((1, 1, 60, 80, STORM_FRAMES), dtype=np.float32)
        if i % POISON_EVERY == POISON_EVERY - 1:
            clip[0, 0, 0, 0, :] = np.nan
        reqs.append(("ABCD"[i % 4], clip))
    _warm(server, reqs[:4], rows=4)

    def evict_one():
        with server.cache._lock:
            keys = list(server.cache._entries)
        if keys:
            server.cache.discard(keys[0])

    chaos = ChaosInjector(
        [
            ChaosRule("dispatch", "raise", rate=0.12),
            ChaosRule("cache_fetch", "latency", rate=0.15, delay_s=0.002),
            ChaosRule("cache_fetch", "call", rate=0.08, action=evict_one),
            ChaosRule("encode", "latency", rate=0.10, delay_s=0.001),
        ],
        seed=0,
    )
    stop = threading.Event()
    churn_k = np.random.RandomState(99).randn(9, 1, 30, 40, 8).astype(np.float32)

    def churn():
        while not stop.is_set():
            server.add_tenant("churn", churn_k, fidelity=fid.physical())
            time.sleep(0.002)
            server.remove_tenant("churn")
            time.sleep(0.002)

    churner = ThreadPoolExecutor(1)
    kernel.reset_launches()
    server.chaos = chaos
    t0 = time.perf_counter()
    with MicrobatchScheduler(
        server, max_queue=2 * STORM_REQUESTS, max_batch=4, batch_wait_s=0.001,
        default_deadline_s=120.0,
        retry=RetryPolicy(max_retries=6, base_s=0.001, cap_s=0.01, seed=0),
        ladder=DegradationLadder(failure_threshold=3, recovery_s=0.05),
    ) as sched:
        churn_job = churner.submit(churn)
        futs = [sched.submit(t, c, block=True) for t, c in reqs]
        kinds, outs = [], []
        for f in futs:
            exc = f.exception(timeout=SCHED_RESULT_TIMEOUT_S)
            if exc is None:
                kinds.append("ok")
                outs.append(f.result())
            else:
                kinds.append("quarantined" if isinstance(exc, TenantQuarantined)
                             else "typed" if isinstance(exc, ServingError) else f"untyped {exc!r}")
                outs.append(None)
        elapsed = time.perf_counter() - t0
        probe = sched.submit("A", reqs[0][1], block=True, deadline_s=0.0)
        deadline_typed = isinstance(probe.exception(timeout=60), DeadlineExceeded)
        # the watchdog resolves the probe at its deadline, possibly before
        # the batcher has taken it off the queue: give the batcher up to
        # STORM_DRAIN_S to take it, then read the backlog before close
        t_drain = time.perf_counter()
        while sched.metrics()["queue_depth"] and time.perf_counter() - t_drain < STORM_DRAIN_S:
            time.sleep(0.005)
        m = sched.metrics()
    stop.set()
    churn_job.result(timeout=60)
    churner.shutdown()
    server.chaos = None
    launches = _launch_counts(kernel)
    pending = [i for i, f in enumerate(futs + [probe]) if not f.done()]
    if pending or m["queue_depth"]:
        raise AssertionError(f"storm: pending after close: {pending}, queue {m['queue_depth']}")
    poisoned = [i for i in range(STORM_REQUESTS) if i % POISON_EVERY == POISON_EVERY - 1]
    quarantined = [i for i, k in enumerate(kinds) if k == "quarantined"]
    if quarantined != poisoned:
        raise AssertionError(f"storm: quarantined {quarantined}, poisoned {poisoned}")
    bad = [k for k in kinds if k.startswith("untyped")]
    if bad:
        raise AssertionError(f"storm: untyped failures {bad}")
    if not deadline_typed:
        raise AssertionError("storm: an expired deadline did not raise DeadlineExceeded")
    rel = max([_check_alone(server, reqs[i], outs[i], f"storm request {i}")
               for i, k in enumerate(kinds) if k == "ok"], default=0.0)
    counts = {k: kinds.count(k) for k in ("ok", "quarantined", "typed")}
    row = {
        "requests": STORM_REQUESTS,
        "frames": STORM_FRAMES,
        **counts,
        "resolved": sum(f.done() for f in futs),
        "retries": m["retries"],
        "faults_injected": chaos.stats()["total_injected"],
        "injected": chaos.stats()["injected"],
        "latency_p99_ms": m["latency_p99_ms"],
        "elapsed_s": elapsed,
        "ladder": m["ladder"],
        "integrity_failures": server.cache.stats()["integrity_failures"],
        "launches": launches,
        "max_rel_vs_alone": rel,
    }
    print(
        f"sched: storm {STORM_REQUESTS} x {STORM_FRAMES} frames: {counts['ok']} results, "
        f"{counts['quarantined']} quarantined (the poisoned {len(poisoned)}), {counts['typed']} "
        f"typed ServingError, 0 pending after close; {m['retries']} retries, "
        f"{row['faults_injected']} faults injected {row['injected']}, pooled trips "
        f"{m['ladder']['breakers']['pooled']['trips']}, p99 {m['latency_p99_ms']:.2f} ms, "
        f"{elapsed:.2f} s; launches {launches}; results vs fault-free alone max rel {rel:.3g}"
    )
    return row


def _breaker(server, kernel, seed: int) -> dict:
    """A pooled-only dispatch fault at rate 1 trips the pooled breaker: the
    next batches run on the sequential rung (B1), answering as the pooled
    rung did; with the fault removed the ladder recovers to pooled."""
    from repro_torch.distributed.fault import ChaosInjector, ChaosRule
    from repro_torch.launch.resilience import DegradationLadder, RetryPolicy
    from repro_torch.launch.serve import MicrobatchScheduler

    gen = np.random.default_rng([seed, 7])
    reqs = [(t, gen.random((1, 1, 60, 80, SCHED_FRAMES), dtype=np.float32)) for t in "ABCD"]
    pooled = server.search_batch(reqs)
    chaos = ChaosInjector([ChaosRule("dispatch", "raise", rate=1.0, mode="pooled")], seed=1)
    ladder = DegradationLadder(failure_threshold=2, recovery_s=BREAKER_RECOVERY_S)
    server.chaos = chaos
    with MicrobatchScheduler(
        server, max_batch=4, batch_wait_s=0.05,
        retry=RetryPolicy(max_retries=1, base_s=1e-4, cap_s=1e-3, seed=0), ladder=ladder,
    ) as sched:
        for _ in range(10):  # trip the breaker
            sched.submit(*reqs[0], block=True).result(timeout=SCHED_RESULT_TIMEOUT_S)
            if ladder.breakers["pooled"].state == "open":
                break
        if ladder.peek() != "sequential":
            raise AssertionError(f"breaker: ladder on {ladder.peek()!r}, not 'sequential'")
        kernel.reset_launches()
        futs = [sched.submit(t, c, block=True) for t, c in reqs]
        degraded = [f.result(timeout=SCHED_RESULT_TIMEOUT_S) for f in futs]
        launches = _launch_counts(kernel)
        if launches["spectral_mac"] <= 0 or launches["spectral_mac_grouped"] != 0:
            raise AssertionError(f"breaker: degraded batches launched {launches}")
        rel = max(_max_rel(d["scores"], p["scores"]) for d, p in zip(degraded, pooled))
        if not rel <= SCHED_RTOL:
            raise AssertionError(f"breaker: sequential rung off the pooled one by {rel:.3g}")
        chaos.rules.clear()
        time.sleep(BREAKER_RECOVERY_S + 0.05)
        for _ in range(20):
            sched.submit(*reqs[1], block=True).result(timeout=SCHED_RESULT_TIMEOUT_S)
            if ladder.breakers["pooled"].state == "closed":
                break
            time.sleep(0.05)
        m = sched.metrics()
    server.chaos = None
    snap = m["ladder"]["breakers"]["pooled"]
    if m["mode"] != "pooled" or snap["recoveries"] < 1:
        raise AssertionError(f"breaker: did not recover to pooled: {m['ladder']}")
    print(f"sched: breaker tripped to 'sequential' (degraded batch launches {launches}, scores vs "
          f"pooled max rel {rel:.3g}), recovered to {m['mode']!r}; ladder {m['ladder']}")
    return {"degraded_launches": launches, "max_rel_vs_pooled": rel, "ladder": m["ladder"]}


def _warm(server, reqs, rows: int) -> None:
    """Record and plan in the caller's thread: pooled and sequential calls
    with 1..rows distinct clips (every cuFFT batch size the phase forms)."""
    for n in range(1, rows + 1):
        # distinct contents, so clip-dedup keeps every row
        batch = [(reqs[i % len(reqs)][0], reqs[i % len(reqs)][1] + np.float32(i)) for i in range(n)]
        server.search_batch(batch)
        server.search_batch(batch, pooled=False)
    torch.cuda.synchronize()


def phase_sched(kernel, seed: int, pooled_fps: float) -> dict:
    """The microbatch scheduler on the paper-geometry server: open-loop
    load at two fractions of the pooled rung's rate, a chaos storm and a
    breaker trip and recovery."""
    t0 = time.perf_counter()
    tenants = _tenants(np.random.RandomState(seed))
    server = _server(tenants)
    gen = np.random.default_rng([seed, 1])
    warm = [(t, gen.random((1, 1, 60, 80, SCHED_FRAMES), dtype=np.float32)) for t in "ABCD"]
    _warm(server, warm, rows=6)
    report = {"rates": [_sched_rate(server, kernel, f, pooled_fps, seed) for f in SCHED_RATES]}
    report["profile"] = _sched_profile(server, pooled_fps, seed)
    report["storm"] = _storm(tenants, kernel)
    report["breaker"] = _breaker(server, kernel, seed)
    report["seconds"] = time.perf_counter() - t0
    print(f"sched: phase {report['seconds']:.1f} s")
    return report


def _replica_server(**cfg):
    """One replica's paper-geometry server (as ``_server``, tenants added
    by the replica set)."""
    from repro_torch.launch.serve import VideoSearchConfig, VideoSearchServer

    return VideoSearchServer(
        frame_hw=(60, 80),
        cfg=VideoSearchConfig(window_frames=64, chunk_windows=4, use_pallas=True, **cfg),
    )


def _replica_set(tenants, clips, n_replicas: int, server_cfg=None, **kw):
    """A ``ReplicaSet`` of paper-geometry replicas holding the four
    tenants.  Each replica's server is built, recorded and warmed at every
    batch size its scheduler can form, on both rungs, before the set
    starts its heartbeats, so building cuFFT plans never looks like a
    dead replica; the set's ``add_tenant`` then hits each server's
    grating cache.  A server the set builds later (a warm restart) is a
    fresh one."""
    from repro_torch.launch.replica import HedgePolicy, ReplicaSet

    server_cfg = server_cfg or {}
    ready = []
    for _ in range(n_replicas):
        server = _replica_server(**server_cfg)
        for name, k, pipe in tenants:
            server.add_tenant(name, k, fidelity=pipe)
        _warm(server, [(t, clips[i % len(clips)]) for i, t in enumerate("ABCD")], REPLICA_WARM_ROWS)
        ready.append(server)
    kw.setdefault("hedge", HedgePolicy(enabled=False))
    kw.setdefault("default_deadline_s", 120.0)
    rs = ReplicaSet(lambda: ready.pop(0) if ready else _replica_server(**server_cfg),
                    n_replicas=n_replicas, **kw)
    for name, k, pipe in tenants:
        rs.add_tenant(name, k, fidelity=pipe)
    return rs


def _sequential_dispatches(rs) -> int:
    with rs._lock:
        replicas = list(rs._replicas.values())
    return sum(r.server.metrics()["sequential_dispatches"] for r in replicas)


def _replica_gather(futs) -> tuple[list, dict]:
    """Every future's outcome within ``SCHED_RESULT_TIMEOUT_S``: the
    result, or None for a typed ServingError or a future that never
    resolved (counted apart)."""
    from concurrent.futures import TimeoutError as FutureTimeoutError

    from repro_torch.launch.resilience import ServingError

    outs, counts = [], {"ok": 0, "typed": 0, "unresolved": 0}
    for f in futs:
        try:
            outs.append(f.result(timeout=SCHED_RESULT_TIMEOUT_S))
            counts["ok"] += 1
        except ServingError:
            outs.append(None)
            counts["typed"] += 1
        except FutureTimeoutError:
            outs.append(None)
            counts["unresolved"] += 1
    return outs, counts


def _replica_report(tag, rs, kernel, seq_before: int, touched: set, extra: dict) -> dict:
    """Counters, latency percentiles, spurious deaths (members dead at the
    end that were never killed or stalled) and the replay's B1/B2/B3
    launches; B2 and B3 must have launched (the pooled rung), B1 exactly
    when a sequential (degraded) batch ran."""
    from repro_torch.distributed.fault import DEAD

    m = rs.metrics()
    launches = _launch_counts(kernel)
    sequential = _sequential_dispatches(rs) - seq_before
    spurious = sorted(n for n, st in m["states"].items() if st == DEAD and n not in touched)
    for k in ("spectral_mac_grouped", "topk_readout"):
        if launches[k] <= 0:
            raise AssertionError(f"replica {tag}: kernel {k} was not launched")
    if (launches["spectral_mac"] > 0) != (sequential > 0):
        raise AssertionError(f"replica {tag}: B1 launched {launches['spectral_mac']} times for "
                             f"{sequential} sequential batches")
    row = {
        **extra,
        **{k: m[k] for k in ("submitted", "completed", "failed", "failovers", "rescued", "hedges",
                             "hedge_wins", "unroutable", "flaps", "deaths", "lost_futures",
                             "latency_p50_ms", "latency_p90_ms", "latency_p99_ms")},
        "spurious_deaths": spurious,
        "sequential_batches": sequential,
        "launches": launches,
        "states": m["states"],
    }
    print(
        f"replica: {tag}: failovers {m['failovers']}, rescued {m['rescued']}, hedges {m['hedges']}, "
        f"wins {m['hedge_wins']}, flaps {m['flaps']}, deaths {m['deaths']}, spurious deaths "
        f"{len(spurious)} {spurious}, lost {m['lost_futures']}; latency p50 {m['latency_p50_ms']:.2f} "
        f"p90 {m['latency_p90_ms']:.2f} p99 {m['latency_p99_ms']:.2f} ms; launches {launches} "
        f"(sequential batches {sequential})"
    )
    return row


def _replica_storm(tenants, clips, kernel, tmp: str) -> dict:
    """benchmarks/chaos.py's ``_replica_storm``: 3 replicas, 60 requests
    over the four tenants, a 50 ms dispatch latency on r1, r1 killed after
    request 20, hedging after a cold 0.25 s; then r1 warm-restarted from
    the manifest on disk, admitted by the bitwise probe (all four
    tenants), and held bitwise against a survivor."""
    from repro_torch.distributed.fault import ChaosInjector, ChaosRule
    from repro_torch.launch.replica import HedgePolicy

    n = REPLICA_STORM_REQUESTS
    rs = _replica_set(
        tenants, clips, 3, ckpt_dir=os.path.join(tmp, "manifest"),
        hedge=HedgePolicy(enabled=True, cold_delay_s=0.25, min_samples=10**9),
    )
    try:
        rs._replicas["r1"].server.chaos = ChaosInjector(
            [ChaosRule("dispatch", "latency", rate=1.0, delay_s=0.05)], seed=2
        )
        reqs = [("ABCD"[i % 4], clips[i % 3]) for i in range(n)]
        kernel.reset_launches()
        seq0 = _sequential_dispatches(rs)
        t0 = time.perf_counter()
        futs, at_kill = [], None
        for i, (t, c) in enumerate(reqs):
            futs.append(rs.submit(t, c, block=True))
            if i == n // 3:
                at_kill = rs._replicas["r1"].metrics()  # what the kill catches
                rs.kill_replica("r1")
            time.sleep(0.001)
        outs, counts = _replica_gather(futs)
        elapsed = time.perf_counter() - t0
        availability = 100.0 * counts["ok"] / n
        resolution = 100.0 * (counts["ok"] + counts["typed"]) / n
        row = _replica_report("storm", rs, kernel, seq0, {"r1"}, {
            "requests": n, **counts, "availability_pct": availability,
            "resolution_pct": resolution, "elapsed_s": elapsed,
        })
        survivor = rs._replicas["r0"]
        rel = max(_check_alone(survivor.server, reqs[i], o, f"replica storm request {i}")
                  for i, o in enumerate(outs) if o is not None)
        t_replace = time.perf_counter()
        replacement = rs.replace_replica("r1")  # the bitwise probe, all four tenants
        replace_s = time.perf_counter() - t_replace
        bitwise = {}
        for t in "ABCD":
            want = survivor.submit(t, clips[1], block=True).result(timeout=SCHED_RESULT_TIMEOUT_S)
            got = replacement.submit(t, clips[1], block=True).result(timeout=SCHED_RESULT_TIMEOUT_S)
            bitwise[t] = bool(np.array_equal(want["scores"].view(np.int32), got["scores"].view(np.int32))
                              and np.array_equal(want["peak_frame"], got["peak_frame"]))
        row["batch_dependence"] = _batch_dependence(survivor.server, clips)
    finally:
        rs.close()
    row |= {"max_rel_vs_alone": rel, "replace_s": replace_s, "warm_restart_bitwise": bitwise,
            "r1_outstanding_at_kill": at_kill["outstanding"], "r1_queue_at_kill": at_kill["queue_depth"]}
    print(
        f"replica: storm {n} x {REPLICA_FRAMES} frames, 3 replicas, r1 killed after request {n // 3} "
        f"with {at_kill['outstanding']} attempts outstanding ({at_kill['queue_depth']} queued): "
        f"{counts['ok']} ok / {counts['typed']} typed / {counts['unresolved']} unresolved, "
        f"availability {availability:.1f}%, resolution {resolution:.1f}%, {elapsed:.2f} s; results vs "
        f"alone max rel {rel:.3g}; r1 replaced from the manifest in {replace_s:.2f} s (probe passed "
        f"for A-D), replacement bitwise a survivor's: {bitwise}"
    )
    if counts["unresolved"] or resolution != 100.0 or row["lost_futures"]:
        raise AssertionError(f"replica storm: {counts}, lost {row['lost_futures']}")
    if availability < REPLICA_AVAILABILITY_MIN:
        raise AssertionError(f"replica storm: availability {availability:.1f}% < 95%")
    if not all(bitwise.values()):
        raise AssertionError(f"replica storm: warm-restarted replica diverged: {bitwise}")
    return row


def _batch_dependence(server, clips) -> dict:
    """Whether one request's scores depend on the batch it lands in: the
    request alone on the pooled rung against the same request with 1, 3
    and 5 other distinct clips in the batch (cuFFT's batch grows), on the
    sequential rung alone, and stacked with a second stream of its
    tenant there.  Bitwise; reported, not gated."""
    req = ("A", clips[0])
    alone = server.search_batch([req])[0]["scores"]

    def same(out):
        return bool(np.array_equal(out["scores"].view(np.int32), alone.view(np.int32)))

    out = {}
    for rows in (2, 4, 6):
        others = [("ABCD"[j % 4], clips[1 + j % 2] + np.float32(j + 1)) for j in range(rows - 1)]
        out[f"pooled_{rows}_rows"] = same(server.search_batch([req] + others)[0])
    out["sequential_alone"] = same(server.search_batch([req], pooled=False)[0])
    out["sequential_stacked_2"] = same(server.search_batch([req, ("A", clips[1])], pooled=False)[0])
    print(f"replica: batch dependence of one request's scores (bitwise equal to it alone on the pooled "
          f"rung): {out}")
    return out


def _replica_hedge(tenants, clips, kernel) -> dict:
    """benchmarks/chaos.py's ``_replica_hedge``: 2 replicas, r0 a
    straggler, 40 sequential searches with hedging off, then on.  The
    reference's 60 ms straggle and 15 ms hedge delay keep their 4 : 1
    ratio on the card: straggle max(60 ms, 4 m), m the median latency of
    one warm request alone on one replica; hedge delay a quarter of it."""
    from repro_torch.distributed.fault import ChaosInjector, ChaosRule
    from repro_torch.launch.replica import HedgePolicy

    n = REPLICA_HEDGE_REQUESTS
    p99, rows, alone_ms = {}, {}, None
    for hedged in (False, True):
        straggle = None if alone_ms is None else max(0.06, 4 * alone_ms / 1e3)
        hedge = HedgePolicy(enabled=hedged, cold_delay_s=(straggle or 0.06) / 4, min_samples=10**9)
        rs = _replica_set(tenants, clips, 2, hedge=hedge, poll_interval_s=0.003)
        try:
            if alone_ms is None:
                lat = []
                for i in range(7):
                    t0 = time.perf_counter()
                    rs._replicas["r1"].submit("ABCD"[i % 4], clips[i % 3], block=True).result(
                        timeout=SCHED_RESULT_TIMEOUT_S)
                    lat.append(time.perf_counter() - t0)
                alone_ms = float(np.median(lat)) * 1e3
                straggle = max(0.06, 4 * alone_ms / 1e3)
                print(f"replica: hedge: one warm request alone on one replica, median {alone_ms:.2f} ms "
                      f"(n=7): straggle {straggle * 1e3:.2f} ms, hedge delay {straggle * 250:.2f} ms")
            rs._replicas["r0"].server.chaos = ChaosInjector(
                [ChaosRule("dispatch", "latency", rate=1.0, delay_s=straggle)], seed=3
            )
            kernel.reset_launches()
            seq0 = _sequential_dispatches(rs)
            lats = []
            for i in range(n):
                t0 = time.perf_counter()
                rs.search("ABCD"[i % 4], clips[i % 3])
                lats.append(time.perf_counter() - t0)
            lats.sort()
            p99[hedged] = 1e3 * lats[min(int(0.99 * len(lats)), len(lats) - 1)]
            tag = "hedge on" if hedged else "hedge off"
            rows[tag] = _replica_report(tag, rs, kernel, seq0, set(), {
                "requests": n, "p99_search_ms": p99[hedged], "straggle_ms": straggle * 1e3,
                "hedge_delay_ms": hedge.cold_delay_s * 1e3,
            })
        finally:
            rs.close()
    ratio = p99[False] / max(p99[True], 1e-9)
    on = rows["hedge on"]
    print(f"replica: hedge: {n} searches, p99 {p99[False]:.2f} ms unhedged -> {p99[True]:.2f} ms hedged "
          f"(ratio {ratio:.2f}), {on['hedges']} hedges, {on['hedge_wins']} wins")
    if not (on["hedges"] > 0 and on["hedge_wins"] > 0):
        raise AssertionError(f"replica hedge: hedges {on['hedges']}, wins {on['hedge_wins']}")
    return {"alone_ms": alone_ms, "p99_unhedged_ms": p99[False], "p99_hedged_ms": p99[True],
            "p99_ratio": ratio, **rows}


def _replica_flap(tenants, clips, kernel) -> dict:
    """benchmarks/chaos.py's ``_replica_flap``: 2 replicas under the
    reference's thresholds (suspect 0.03 s, dead 0.06 s, beats every
    5 ms, polls every 3 ms), r0's heartbeats stalled for 40 ms (every
    third time 80 ms) and revived in a loop while 48 requests arrive
    10 ms apart."""
    n = REPLICA_FLAP_REQUESTS
    rs = _replica_set(tenants, clips, 2, suspect_after_s=0.03, dead_after_s=0.06,
                      heartbeat_interval_s=0.005, poll_interval_s=0.003)
    stop = threading.Event()

    def flapper():
        k = 0
        while not stop.is_set():
            rs.stall_replica("r0")
            time.sleep(0.08 if k % 3 == 2 else 0.04)
            rs.revive_replica("r0")
            k += 1
            time.sleep(0.01)

    churn = ThreadPoolExecutor(1)
    try:
        kernel.reset_launches()
        seq0 = _sequential_dispatches(rs)
        job = churn.submit(flapper)
        futs = []
        for i in range(n):
            futs.append(rs.submit("ABCD"[i % 4], clips[i % 3], block=True))
            time.sleep(0.01)
        outs, counts = _replica_gather(futs)
        stop.set()
        job.result(timeout=60)
        resolution = 100.0 * (counts["ok"] + counts["typed"]) / n
        row = _replica_report("flap", rs, kernel, seq0, {"r0"}, {
            "requests": n, **counts, "resolution_pct": resolution,
            "availability_pct": 100.0 * counts["ok"] / n,
        })
    finally:
        stop.set()
        churn.shutdown()
        rs.close()
    print(f"replica: flap {n} requests under stall/revive churn: {counts['ok']} ok / {counts['typed']} "
          f"typed / {counts['unresolved']} unresolved, resolution {resolution:.1f}%")
    if counts["unresolved"] or resolution != 100.0 or row["lost_futures"]:
        raise AssertionError(f"replica flap: {counts}, lost {row['lost_futures']}")
    if row["flaps"] + row["deaths"] <= 0:
        raise AssertionError("replica flap: the churn never produced a flap or a death")
    return row


def _replica_mesh(tenants, clips, kernel, tmp: str) -> dict:
    """Two replicas, each serving on its own (1, 2) logical mesh of the
    card; r0 killed after a third of 24 requests.  Every future resolves,
    0 lost, every result bitwise the single-device answer to the same
    request; r0 warm-restarted from the manifest owns a new mesh, passes
    the bitwise probe and answers all four tenants bitwise the
    single-device server's."""
    from repro_torch.launch.replica import HedgePolicy

    n = 24
    mesh_cfg = {"mesh_shape": (1, 2), "mesh_devices": ("cuda:0",) * 2}
    single = _replica_server()
    for name, k, pipe in tenants:
        single.add_tenant(name, k, fidelity=pipe)
    rs = _replica_set(tenants, clips, 2, server_cfg=mesh_cfg, ckpt_dir=os.path.join(tmp, "manifest"),
                      hedge=HedgePolicy(enabled=False))
    try:
        meshes = {name: rs._replicas[name].mesh for name in ("r0", "r1")}
        reqs = [("ABCD"[i % 4], clips[i % 3]) for i in range(n)]
        kernel.reset_launches()
        seq0 = _sequential_dispatches(rs)
        futs = []
        for i, (t, c) in enumerate(reqs):
            futs.append(rs.submit(t, c, block=True))
            if i == n // 3:
                rs.kill_replica("r0")
        outs, counts = _replica_gather(futs)
        row = _replica_report("mesh (1, 2)", rs, kernel, seq0, {"r0"}, {"requests": n, **counts})
        alone = {}
        same = []
        for (t, c), o in zip(reqs, outs):
            key = (t, id(c))
            if key not in alone:
                alone[key] = single.search_batch([(t, c)])[0]["scores"]
            same.append(o is not None and np.array_equal(o["scores"].view(np.int32),
                                                         alone[key].view(np.int32)))
        replacement = rs.replace_replica("r0")  # the bitwise probe, all four tenants
        new_mesh = replacement.mesh
        own = (new_mesh is not None and new_mesh is not meshes["r0"] and new_mesh is not meshes["r1"]
               and replacement.metrics()["mesh"] == {"data": 1, "model": 2})
        restart_bitwise = {}
        for t in "ABCD":
            got = replacement.submit(t, clips[1], block=True).result(timeout=SCHED_RESULT_TIMEOUT_S)
            want = single.search_batch([(t, clips[1])])[0]
            restart_bitwise[t] = bool(np.array_equal(got["scores"].view(np.int32), want["scores"].view(np.int32))
                                      and np.array_equal(got["peak_frame"], want["peak_frame"]))
    finally:
        rs.close()
    row |= {"bitwise_single_device": sum(same), "replacement_owns_new_mesh": own,
            "restart_bitwise": restart_bitwise}
    print(
        f"replica: mesh (1, 2) x 2 replicas, {n} x {REPLICA_FRAMES} frames, r0 killed after request "
        f"{n // 3}: {counts['ok']} ok / {counts['typed']} typed / {counts['unresolved']} unresolved, lost "
        f"{row['lost_futures']}; {sum(same)} of {n} results bitwise the single-device server's; r0 "
        f"replaced with a new LocalMesh: {own}, bitwise the single-device server for A-D: {restart_bitwise}"
    )
    if counts["unresolved"] or counts["typed"] or row["lost_futures"]:
        raise AssertionError(f"replica mesh: {counts}, lost {row['lost_futures']}")
    if not all(same) or not own or not all(restart_bitwise.values()):
        raise AssertionError(f"replica mesh: bitwise {sum(same)}/{n}, own mesh {own}, "
                             f"restart {restart_bitwise}")
    return row


def phase_replica(kernel, seed: int) -> dict:
    """The replicated video search on the card: benchmarks/chaos.py's
    three replica rows (storm, hedge, flap) at their request counts, on
    paper-geometry replicas holding the four tenants, 1024-frame clips."""
    import tempfile

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tenants = _tenants(np.random.RandomState(seed))
    gen = np.random.default_rng([seed, 3])
    clips = [gen.random((1, 1, 60, 80, REPLICA_FRAMES), dtype=np.float32) for _ in range(3)]
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        report["storm"] = _replica_storm(tenants, clips, kernel, tmp)
    report["hedge"] = _replica_hedge(tenants, clips, kernel)
    report["flap"] = _replica_flap(tenants, clips, kernel)
    with tempfile.TemporaryDirectory() as tmp:
        report["mesh"] = _replica_mesh(tenants, clips, kernel, tmp)
    torch.cuda.synchronize()
    report["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    report["seconds"] = time.perf_counter() - t0
    print(f"replica: phase {report['seconds']:.1f} s, peak device memory "
          f"{report['peak_device_bytes'] / 2**20:.1f} MiB")
    return report


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        words = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(words), b.view(words))
    return torch.equal(a, b)


def phase_ckpt(seed: int) -> dict:
    """Checkpoints of mamba2-370m's parameters (bf16, built on the card by
    the port's init) and a small float32 / int64 tree through
    ``CheckpointManager(async_save=True, keep=2)``: the synchronous
    snapshot ms, the write seconds (``wait()``) and the restore seconds
    onto the card; the restore must be bitwise, and a ``ckpt_write`` fault
    on a third save must surface on ``wait()`` and leave the second
    intact."""
    import tempfile

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.distributed.fault import ChaosInjector, ChaosRule, InjectedFault
    from repro_torch.models import mamba2

    cfg = configs.get_config("mamba2-370m")
    gen = torch.Generator("cuda").manual_seed(seed)
    params = mamba2.init_params(cfg, gen, device="cuda").state_dict()
    small = {
        "f32": torch.randn((64, 33), generator=gen, device="cuda"),
        "i64": [torch.arange(10, device="cuda"), {"step": torch.zeros((), dtype=torch.int64, device="cuda")}],
    }
    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    dtypes = sorted({str(t.dtype).removeprefix("torch.") for t in params.values()})
    report = {"param_leaves": len(params), "param_bytes": nbytes, "param_dtypes": dtypes}

    def trees():
        return {"params": params, "small": small}

    def restore_onto_card():
        step, host = mgr.restore_latest(trees())
        return step, {name: _map_leaves(tree, lambda t: t.to("cuda")) for name, tree in host.items()}

    def check(restored, step):
        bad = [k for k, v in params.items() if not _same_bits(restored["params"][k], v)]
        got = restored["small"]
        pairs = [(got["f32"], small["f32"]), (got["i64"][0], small["i64"][0]),
                 (got["i64"][1]["step"], torch.tensor(step, device="cuda"))]
        bad += [f"small/{i}" for i, (g, w) in enumerate(pairs) if not _same_bits(g, w)]
        if bad:
            raise AssertionError(f"ckpt: step {step} restored with different bits in {bad[:5]}")

    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        free = shutil.disk_usage(tmp).free
        report["free_bytes"] = free
        print(f"ckpt: {tmp}: {free / 2**30:.1f} GiB free; mamba2-370m params {len(params)} leaves, "
              f"{nbytes / 2**30:.3f} GiB {dtypes}, plus a float32 / int64 tree")
        mgr = CheckpointManager(ckpt_dir, keep=2, async_save=True)
        snap_ms, write_s = [], []
        for step in (1, 2):
            small["i64"][1]["step"].fill_(step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(step, trees(), extra={"model": "mamba2-370m"})
            snap_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            mgr.wait()
            write_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        step, restored = restore_onto_card()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(restored, step)
        if step != 2:
            raise AssertionError(f"ckpt: latest step {step}, not 2")
        print(f"ckpt: snapshot (synchronous, device to host) {snap_ms[0]:.1f} / {snap_ms[1]:.1f} ms, "
              f"write (wait) {write_s[0]:.2f} / {write_s[1]:.2f} s, restore of step 2 onto the card "
              f"{restore_s:.2f} s; bitwise equal to the originals (bf16 included)")
        # an injected crash in the third save's first payload write
        mgr.chaos = ChaosInjector([ChaosRule("ckpt_write", "raise", at=(1,))])
        small["i64"][1]["step"].fill_(3)
        mgr.save(3, trees())
        try:
            mgr.wait()
            surfaced = False
        except InjectedFault:
            surfaced = True
        latest = latest_step(ckpt_dir)
        if not surfaced or latest != 2:
            raise AssertionError(f"ckpt: injected write fault surfaced {surfaced}, latest step {latest}")
        mgr.chaos = None
        _, restored = restore_onto_card()
        check(restored, 2)
        print("ckpt: a ckpt_write fault in save 3 surfaced on wait(); latest_step is 2 and its bytes "
              "restore intact")
    report |= {"snapshot_ms": snap_ms, "write_s": write_s, "restore_s": restore_s,
               "fault_surfaced": surfaced}
    return report


def _by_kind(by_name: dict) -> dict:
    """A profile's device ms summed by kind of kernel: B5, B6, cuBLAS
    GEMMs, PyTorch's elementwise kernels, and the rest."""
    kinds = {"B5": 0.0, "B6": 0.0, "gemm": 0.0, "elementwise": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        kind = ("B5" if "ssd_" in name else "B6" if "flash" in name
                else "gemm" if any(m in name for m in ("nvjet", "gemm", "cutlass", "xmma"))
                else "elementwise" if "elementwise" in name else "other")
        kinds[kind] += ms
    return kinds


def _serve_lm(tag, cfg, server_for, gen, kernels, card="", prompt_for=None) -> tuple[dict, dict, dict]:
    """``LMServer.generate`` over ``LM_BATCHES``: one warm-up, then
    ``LM_REPS`` timed prefill-only and full calls per batch.  ``prompt_for(B,
    S)`` builds a batch's prompts (default: random (B, S) tokens on the
    card from ``gen``; the batch dict of the audio and VLM families).  ``kernels``
    holds (wrapper, launches per prefill, reset) for each kernel of the
    path; each counter, zeroed before the timed calls, must read that
    many x the prefills run (so decode launches none).  Then one profiled
    prefill of each batch (``rec["profile_prefill"]``) and one profiled
    generate of batch one.  Returns the report, the prompts by (rows,
    length) and the servers by (rows, length)."""
    report = {"config": cfg.name, "params": cfg.num_params(), "batches": {}}
    launches = {fn.__name__: 0 for fn, _, _ in kernels}
    suffix = f" [{card}]" if card else ""
    prompts_by, servers = {}, {}
    for Bb, S, n_new in LM_BATCHES:
        server = servers[(Bb, S)] = server_for(S + n_new)
        if prompt_for is None:
            prompts = torch.randint(0, cfg.vocab, (Bb, S), generator=gen, device="cuda")
        else:
            prompts = prompt_for(Bb, S)
        prompts_by[(Bb, S)] = prompts
        server.generate(prompts, n_new)  # warm: cuBLAS handles, allocator
        server.generate(prompts, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _, _, reset in kernels:
            reset()
        pre, full, outs = [], [], []
        for _ in range(LM_REPS):
            t0 = time.perf_counter()
            server.generate(prompts, 1)  # prefill + argmax; ends in a host copy
            pre.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            outs.append(server.generate(prompts, n_new))
            full.append(time.perf_counter() - t0)
        prefills = 2 * LM_REPS
        n_launch = {}
        for fn, per_prefill, _ in kernels:
            n_launch[fn.__name__] = fn.launches
            if fn.launches != per_prefill * prefills:
                raise AssertionError(
                    f"{fn.__name__} launched {fn.launches} times for {prefills} prefills, "
                    f"{per_prefill} each"
                )
            launches[fn.__name__] += fn.launches
        for o in outs:
            if o.shape != (Bb, n_new) or not ((0 <= o) & (o < cfg.vocab)).all():
                raise AssertionError(f"bad tokens {o!r}")
            if not np.array_equal(o, outs[0]):
                raise AssertionError("a repeated generate answered differently")
        med_pre, med_full = float(np.median(pre)), float(np.median(full))
        dec_s = (med_full - med_pre) / (n_new - 1)
        rec = {
            "prompts": Bb, "prompt_tokens": S, "new_tokens": n_new,
            "prefill_s": pre, "generate_s": full,
            "prefill_median_ms": med_pre * 1e3,
            "decode_ms_per_token": dec_s * 1e3,
            "prefill_tokens_per_s": Bb * S / med_pre,
            "decode_tokens_per_s": Bb / dec_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "kernel_launches": n_launch,
            "first_tokens": outs[0][:, :8].tolist(),
        }
        report["batches"][f"{Bb}x{S}+{n_new}"] = rec
        print(
            f"{tag}: {Bb}x{S} prefill median {med_pre * 1e3:.2f} ms (min {min(pre) * 1e3:.2f}, "
            f"max {max(pre) * 1e3:.2f}, n={len(pre)}) {rec['prefill_tokens_per_s']:.1f} tok/s; "
            f"decode {dec_s * 1e3:.3f} ms/token {rec['decode_tokens_per_s']:.1f} tok/s "
            f"(generate {n_new}: median {med_full * 1e3:.2f} ms); peak mem "
            f"{rec['max_memory_allocated'] / 2**30:.2f} GiB; "
            + ", ".join(f"{n} launches {c}" for n, c in n_launch.items()) + suffix
        )
    report["kernel_launches"] = launches

    # where the time goes: a profiled prefill of each batch and one
    # profiled generate of batch one
    runs = [(f"{Bb}x{S}+{n}", "prefill", (Bb, S), 1) for Bb, S, n in LM_BATCHES]
    Bb, S, n_new = LM_BATCHES[0]
    runs.append((f"{Bb}x{S}+{n_new}", "generate", (Bb, S), n_new))
    for key, name, shape, n in runs:
        prof = _profile(lambda n=n, shape=shape: servers[shape].generate(prompts_by[shape], n))
        report["batches"][key][f"profile_{name}"] = prof
        if shape == (Bb, S):
            report[f"profile_{name}"] = prof
        busy = ("not measured" if prof["busy_share"] is None
                else f"{prof['device_ms']:.2f} ms ({prof['busy_share']:.1%})")
        print(f"profile: {tag} {name:8s} {key} wall {prof['wall_ms']:.2f} ms, device busy {busy}{suffix}")
        for kn, ms in prof["top_kernels_ms"]:
            print(f"profile:   {ms:9.3f} ms  {kn}")
        kinds = prof["by_kind_ms"] = _by_kind(prof["by_name_ms"])
        print(f"profile: {tag} {name:8s} {key} by kind: "
              + ", ".join(f"{k} {ms:.3f} ms" for k, ms in kinds.items()) + suffix)
    return report, prompts_by, servers


def _ssd_launch_args(args, chunk) -> list[torch.Tensor]:
    """A Mamba-2 block's SSD operands (x, dt, A, B, C) as ``ssd_ops.ssd``
    hands them to B5: padded along L to a multiple of the chunk."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    x, dt, A, B, C = args
    x, dt, B, C = ssd_ops.pad_to_chunk(x, dt, B, C, chunk)
    return [t.contiguous() for t in (x, dt, A, B, C)]


def _b5_check(phase, args, chunk, card=""):
    """B5 against its plain version on the same inputs: y and the final
    state within ``SSD_RTOL`` (relative L2).  Returns (worst relative L2,
    max abs error)."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ref as ssd_ref

    y_k, s_k = ssd_kernel.ssd_chunked_cuda(*args, chunk)
    y_p, s_p = ssd_ref.ssd_chunked_ref(*args, chunk=chunk)
    rel_y, rel_s = _rel_l2(y_k, y_p), _rel_l2(s_k, s_p)
    mx = max(float(torch.max(torch.abs(y_k - y_p))), float(torch.max(torch.abs(s_k - s_p))))
    Bb, L, H, P = args[0].shape
    N = args[3].shape[3]
    print(
        f"{phase}: B5 ({chunk}, {P}, {N}) vs plain on layer-0 inputs {Bb}x{L}: "
        f"y rel L2 {rel_y:.3g}, S rel L2 {rel_s:.3g}, max abs {mx:.3g}" + (f" [{card}]" if card else "")
    )
    if not (rel_y <= SSD_RTOL and rel_s <= SSD_RTOL):
        raise AssertionError(f"B5 disagrees with its plain version (y {rel_y:.3g}, S {rel_s:.3g})")
    return max(rel_y, rel_s), mx


def _b5_row(phase, name, args, chunk, launches, passes, card="") -> dict:
    """B5 checked (``_b5_check``) and timed beside its plain version, as a
    ``kernel:`` row; ``passes`` are its passes' device ms per call in a
    profiled prefill that launched it at this shape (``_b5_passes``)."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ref as ssd_ref

    rel, mx = _b5_check(phase, args, chunk, card)
    Bb, L, H, P = args[0].shape
    G, N = args[3].shape[2:]
    ms = _time_ms(lambda: ssd_kernel.ssd_chunked_cuda(*args, chunk), 20)
    plain_ms = _time_ms(lambda: ssd_ref.ssd_chunked_ref(*args, chunk=chunk), 3)
    print(f"{phase}: B5 {Bb}x{L} passes per call in a profiled prefill: "
          + ", ".join(f"{n} {p_ms:.4f} ms" for n, p_ms in passes.items())
          + (f" [{card}]" if card else ""))
    # the products run on the TF32 tensor cores, three per product
    # (3xTF32); the FMA pipes' float32 bound is kept beside it
    shape = dict(Bb=Bb, L=L, H=H, G=G, P=P, N=N, chunk=chunk)
    bound, by = _kernel_bound("ssd", **shape)
    bound_f32 = _kernel_bound("ssd", roofline.PEAK_FLOPS_F32, **shape)[0]
    return {
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:82",
        "launches": launches,
        "max_abs_err": mx,
        "max_err": mx,
        "rel_l2": rel,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "bound_f32_fma_ms": bound_f32,
        "library_ms": None,
        "passes_ms": passes,
        "shape": {"Bb": Bb, "L": L, "H": H, "G": G, "P": P, "N": N, "chunk": chunk},
    }


def phase_lm(seed: int) -> tuple[dict, list[dict]]:
    """LM serving at mamba2-370m's published config; returns the report
    and the B5 kernel rows."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.launch.serve import LMServer
    from repro_torch.models import mamba2

    cfg = configs.get_config("mamba2-370m")
    gen = torch.Generator("cuda").manual_seed(seed)
    server = LMServer(cfg, mamba2.init_params(cfg, gen, device="cuda"), device="cuda")
    report, prompts_by, _ = _serve_lm(
        "lm", cfg, lambda max_len: server, gen,
        [(ssd_kernel.ssd_chunked_cuda, cfg.n_layers, ssd_kernel.reset_launches)],
    )
    launches = report["kernel_launches"]["ssd_chunked_cuda"]
    prompts = prompts_by[LM_BATCHES[0][:2]]

    # B5 against its plain version on layer 0's SSD operands as the
    # model launches it: batch one, batch two's 2 x 1000 prompts padded
    # to the 2 x 1024 grid, one 2048-token prompt (Bb·H = 32 heads), and
    # the (16, 16, 16) build that ``serve --mode lm`` runs on the smoke
    # config; pass times from a profiled prefill of the same prompts
    def b5_inputs(m, c, toks):
        with torch.inference_mode():
            x0 = m.embed.to(c.compute_dtype)[toks]
            return _ssd_launch_args(m.layers[0].ssd_inputs(x0), c.chunk)

    model = server.model
    server.generate(prompts[:1], 1)  # warm the 1 x 2048 shape before its profile
    two = "x".join(map(str, LM_BATCHES[1][:2])) + f"+{LM_BATCHES[1][2]}"
    rows = []
    for tag, toks, prof in (
        ("", prompts, report["profile_prefill"]),
        ("[2x1024]", prompts_by[LM_BATCHES[1][:2]], report["batches"][two]["profile_prefill"]),
        ("[1x2048]", prompts[:1], _profile(lambda: server.generate(prompts[:1], 1))),
    ):
        args = b5_inputs(model, cfg, toks)
        rows.append(_b5_row("lm", f"ssd_chunked{tag}", args, cfg.chunk, launches,
                            _b5_passes(prof, cfg.n_layers)))
        del args
    scfg = configs.get_smoke_config("mamba2-370m")
    small = mamba2.init_params(scfg, gen, device="cuda")
    toks = torch.randint(0, scfg.vocab, (2, 64), generator=gen, device="cuda")
    rel, mx = _b5_check("lm", b5_inputs(small, scfg, toks), scfg.chunk)
    report["b5_smoke_build"] = {"rel_l2": rel, "max_abs_err": mx, "shape": [2, 64]}
    del small

    # a 2-layer float32 model at full width: kernel route == plain route
    cfg2 = dataclasses.replace(
        cfg, n_layers=2, param_dtype=torch.float32, compute_dtype=torch.float32
    )
    m_kernel = mamba2.init_params(cfg2, gen, device="cuda")
    m_plain = mamba2.Mamba2(dataclasses.replace(cfg2, ssd_impl="chunked"), "cuda")
    m_plain.load_state_dict(m_kernel.state_dict())
    with torch.inference_mode():
        l_kernel, _ = m_kernel.prefill(prompts_by[LM_BATCHES[1][:2]])
        l_plain, _ = m_plain.prefill(prompts_by[LM_BATCHES[1][:2]])
    rel = _rel_l2(l_kernel.float(), l_plain.float())
    report["f32_2layer_logits_rel_l2"] = rel
    print(f"lm: 2-layer f32 last logits, kernel vs plain route: rel L2 {rel:.3g}")
    if not (rel <= LM_RTOL and torch.isfinite(l_kernel).all()):
        raise AssertionError(f"kernel and plain routes disagree: rel L2 {rel:.3g}")
    return report, rows


def _b6_check(phase, tag, q, k, v, causal, rtol, atol=None, card="") -> dict:
    """B6 against its plain version; in bf16 also the worst row and the
    max abs error against the plain version on float32 inputs."""
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.flash import ref as flash_ref

    o_k = flash_kernel.flash_fwd_cuda(q, k, v, causal)
    o_p = flash_ref.flash_ref(q, k, v, causal=causal)
    rel = _rel_l2(o_k.float(), o_p.float())
    mx = float(torch.max(torch.abs(o_k.float() - o_p.float())))
    ok = rel <= rtol and (atol is None or mx <= atol) and bool(torch.isfinite(o_k).all())
    res = {"rel_l2": rel, "max_abs_err": mx}
    line = f"rel L2 {rel:.3g}, max abs {mx:.3g}"
    if q.dtype == torch.bfloat16:
        D = q.shape[-1]
        o_f = flash_ref.flash_ref(q.float(), k.float(), v.float(), causal=causal)
        err = (o_k.float() - o_f).reshape(-1, D)
        row = float(torch.max(
            torch.linalg.vector_norm(err, dim=1)
            / torch.linalg.vector_norm(o_f.reshape(-1, D), dim=1).clamp_min(1e-30)
        ))
        abs_f = float(torch.max(torch.abs(err)))
        vmax = float(torch.max(torch.abs(v.float())))
        ok = ok and row <= FLASH_BF16_ROW_RTOL and abs_f <= FLASH_BF16_ABS_V * vmax
        res.update(worst_row_rel_l2=row, max_abs_err_f32=abs_f, max_abs_v=vmax)
        line += (f"; vs plain on float32 inputs: worst row rel L2 {row:.3g} "
                 f"(<= {FLASH_BF16_ROW_RTOL:g}), max abs {abs_f:.3g} = {abs_f / vmax:.3g} max|v| "
                 f"(<= {FLASH_BF16_ABS_V:g})")
        del o_f, err
    print(
        f"{phase}: B6 {tag} q {tuple(q.shape)} kv {tuple(k.shape)} {q.dtype} "
        f"causal={causal} vs plain: {line}" + (f" [{card}]" if card else "")
    )
    if not ok:
        raise AssertionError(f"B6 {tag} disagrees with its plain version: {res}")
    return res


def _b6_row(phase, name, q, k, v, launches, card="", causal=True) -> dict:
    """B6 in bf16 at a main path's shape (causal with Sq = Sk, or full
    over any Sk), checked (``_b6_check``) and timed beside its plain
    version and one ``scaled_dot_product_attention`` call, as a
    ``kernel:`` row."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.flash import ref as flash_ref

    Bb, S, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    res = _b6_check(phase, f"[{Bb}x{S}" + (f"x{Sk}]" if Sk != S else "]"), q, k, v, causal,
                    FLASH_BF16_RTOL, card=card)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = _time_ms(lambda: flash_kernel.flash_fwd_cuda(q, k, v, causal), 20)
    plain_ms = _time_ms(lambda: flash_ref.flash_ref(q, k, v, causal=causal), 3)
    lib_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True), 20
    )
    bound, by = _kernel_bound("flash_fwd", B=Bb, Sq=S, Sk=Sk, H=H, G=G, D=D, causal=causal, dtype=q.dtype)
    return {
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash/csrc/flash_wgmma.cu",
        "replaces": "src/repro/kernels/flash/kernel.py:94",
        "launches": launches,
        "max_abs_err": res["max_abs_err"],
        "max_err": res["max_abs_err"],
        "rel_l2": res["rel_l2"],
        "worst_row_rel_l2": res["worst_row_rel_l2"],
        "max_abs_err_f32": res["max_abs_err_f32"],
        "max_abs_v": res["max_abs_v"],
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": lib_ms,
        "shape": {"B": Bb, "Sq": S, "Sk": Sk, "H": H, "G": G, "D": D,
                  "dtype": "bfloat16", "causal": causal},
    }


@contextlib.contextmanager
def _dot_f32_decode():
    """Decode attention on its ``_dot_f32`` route (the cache widened to
    float32) whatever the tensors, for the comparison with the bf16-GEMM
    route."""
    from repro_torch.models import common

    route = common._bf16_gemm_route
    common._bf16_gemm_route = lambda q, k, v: False
    try:
        yield
    finally:
        common._bf16_gemm_route = route


def _decode_route_check(cfg, qkv, batch, server, prompts, batches) -> dict:
    """At layer 0's decode shapes (the last prompt position's q against
    a cache of prompt + new tokens), decode attention's bf16-GEMM route
    against its ``_dot_f32`` route on the same tensors: each
    product's float32 output within ``DECODE_DOT_RTOL``, the bf16 output
    within ``DECODE_OUT_RTOL``, and no cache-sized float32 copy (the
    route's extra peak memory below the cache's float32 bytes).  Then
    decode ms/token of ``generate`` on each route, in turns."""
    from repro_torch.models import common

    Bb, S, n_new = batch
    q, k, v = qkv
    M, G, D, H = S + n_new, k.shape[2], k.shape[3], q.shape[2]
    R = H // G
    kc = torch.zeros((Bb, M, G, D), dtype=k.dtype, device="cuda")
    vc = torch.zeros_like(kc)
    kc[:, :S], vc[:, :S] = k, v
    q1 = q[:, -1:].contiguous()
    kv_len = torch.full((Bb,), S, dtype=torch.int32, device="cuda")
    res = {}
    with torch.inference_mode():
        for name, ctx in (("gemm", contextlib.nullcontext()), ("dot_f32", _dot_f32_decode())):
            with ctx:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = common.decode_attention(q1, kc, vc, kv_len)
                torch.cuda.synchronize()
                res[name] = (out, torch.cuda.max_memory_allocated() - base)
        rel_out = _rel_l2(res["gemm"][0].float(), res["dot_f32"][0].float())
        qf = (q1 * (1.0 / D ** 0.5)).reshape(Bb, 1, G, R, D)
        s_g = common._cache_dot(qf.permute(0, 2, 3, 1, 4).reshape(Bb, G, R, D), kc, True)
        s_d = common._dot_f32("bqgrd,bkgd->bgrqk", qf, kc)
        rel_s = _rel_l2(s_g.reshape(s_d.shape), s_d)
        p = torch.exp(s_d - s_d.amax(-1, keepdim=True)).to(vc.dtype)
        o_g = common._cache_dot(p.reshape(Bb, G, R, M), vc, False)
        o_d = common._dot_f32("bgrqk,bkgd->bgrqd", p, vc)
        rel_o = _rel_l2(o_g.reshape(o_d.shape), o_d)
    cache_f32 = kc.numel() * 4
    extra = {name: r[1] for name, r in res.items()}
    print(
        f"lm_dense: decode route: attention q {tuple(q1.shape)} cache {tuple(kc.shape)} bf16, "
        f"bf16-GEMM vs _dot_f32 route: q.k rel L2 {rel_s:.3g}, p.v rel L2 {rel_o:.3g} "
        f"(<= {DECODE_DOT_RTOL:g}), output rel L2 {rel_out:.3g} (<= {DECODE_OUT_RTOL:g}); "
        f"extra peak memory {extra['gemm'] / 2**20:.2f} MiB vs {extra['dot_f32'] / 2**20:.2f} MiB "
        f"(the cache in float32: {cache_f32 / 2**20:.2f} MiB)"
    )
    if not (rel_s <= DECODE_DOT_RTOL and rel_o <= DECODE_DOT_RTOL and rel_out <= DECODE_OUT_RTOL):
        raise AssertionError(f"decode routes disagree: q.k {rel_s:.3g}, p.v {rel_o:.3g}, out {rel_out:.3g}")
    if not extra["gemm"] < cache_f32:
        raise AssertionError(f"the bf16-GEMM route allocated {extra['gemm']} bytes, a cache-sized copy")
    # decode ms/token on each route, in turns (gemm, dot, dot, gemm, ...)
    pre = batches[f"{Bb}x{S}+{n_new}"]["prefill_median_ms"]
    full = {"gemm": [], "dot_f32": []}
    for name in ("gemm", "dot_f32", "dot_f32", "gemm", "gemm", "dot_f32"):
        with contextlib.nullcontext() if name == "gemm" else _dot_f32_decode():
            t0 = time.perf_counter()
            server.generate(prompts, n_new)
            full[name].append(time.perf_counter() - t0)
    dec = {n: (float(np.median(t)) * 1e3 - pre) / (n_new - 1) for n, t in full.items()}
    print(f"lm_dense: decode route: {Bb}x{S}+{n_new}: {dec['gemm']:.3f} ms/token on the bf16-GEMM "
          f"route, {dec['dot_f32']:.3f} ms/token on the _dot_f32 route (3 calls each, in turns)")
    # the device's share, which the host's load does not move: one
    # profiled generate on each route
    dev_ms = {}
    for name in ("gemm", "dot_f32"):
        with contextlib.nullcontext() if name == "gemm" else _dot_f32_decode():
            dev_ms[name] = _profile(lambda: server.generate(prompts, n_new))["device_ms"]
    shown = {n: "not measured" if v is None else f"{v:.2f} ms" for n, v in dev_ms.items()}
    print(f"lm_dense: decode route: device time of one generate {Bb}x{S}+{n_new}: {shown['gemm']} on the "
          f"bf16-GEMM route, {shown['dot_f32']} on the _dot_f32 route")
    return {"qk_rel_l2": rel_s, "pv_rel_l2": rel_o, "out_rel_l2": rel_out,
            "extra_peak_bytes": extra, "cache_f32_bytes": cache_f32,
            "decode_ms_per_token": dec, "generate_device_ms": dev_ms}


def phase_lm_dense(seed: int) -> tuple[dict, list[dict]]:
    """Dense-transformer LM serving at qwen2-1.5b's published config;
    returns the report and the B6 kernel rows."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.launch.serve import LMServer
    from repro_torch.models import transformer

    cfg = configs.get_config("qwen2-1.5b")
    gen = torch.Generator("cuda").manual_seed(seed)
    model = transformer.init_params(cfg, gen, device="cuda")
    report, prompts_by, _ = _serve_lm(
        "lm_dense", cfg,
        lambda max_len: LMServer(cfg, model, max_len=max_len, device="cuda"),
        gen, [(flash_kernel.flash_fwd_cuda, cfg.n_layers, flash_kernel.reset_launches)],
    )
    launches = report["kernel_launches"]["flash_fwd_cuda"]

    def layer0_qkv(m, toks):
        with torch.inference_mode():
            B, S = toks.shape
            pos = torch.arange(S, device="cuda")[None].expand(B, S)
            return m.layers[0].qkv(m.embed.to(m.cfg.compute_dtype)[toks], pos)

    report["decode_route"] = _decode_route_check(
        cfg, layer0_qkv(model, prompts_by[LM_BATCHES[0][:2]]), LM_BATCHES[0],
        LMServer(cfg, model, max_len=sum(LM_BATCHES[0][1:]), device="cuda"),
        prompts_by[LM_BATCHES[0][:2]], report["batches"],
    )

    # B6 at the main path's shapes: layer 0's real q, k, v of both batches
    rows = []
    for Bb, S, _ in LM_BATCHES:
        q, k, v = layer0_qkv(model, prompts_by[(Bb, S)])
        rows.append(_b6_row("lm_dense", f"flash_fwd[{Bb}x{S}]", q, k, v, launches))
        del q, k, v

    # the bf16 build on the sweep's shapes
    bf16 = {}
    for B, Sq, Sk, H, G, D, causal in FLASH_BF16_SWEEP:
        q, k, v = (
            torch.randn((B, S, n, D), generator=gen, device="cuda").to(torch.bfloat16)
            for S, n in ((Sq, H), (Sk, G), (Sk, G))
        )
        tag = f"bf16[{B}x{Sq}x{Sk},h{H},g{G},d{D},{'causal' if causal else 'full'}]"
        bf16[tag] = _b6_check("lm_dense", tag, q, k, v, causal, FLASH_BF16_RTOL)
    report["b6_bf16_checks"] = bf16

    # float32 builds: the reference test sweep's shapes (head dims 16 and
    # 32, both mask settings, ragged lengths, the 40-vs-100 cross case),
    # head dim 160 ragged without the mask, and the qwen2 smoke config's
    # layer 0 (head dim 24), which ``serve --mode lm`` runs
    f32 = {}
    for B, Sq, Sk, H, G, D, causal in (
        (2, 37, 37, 4, 2, 16, True), (2, 37, 37, 4, 4, 16, False),
        (2, 96, 96, 8, 4, 32, True), (2, 71, 71, 2, 2, 32, False),
        (1, 40, 100, 4, 2, 16, False), (1, 130, 130, 4, 2, 160, False), *FLASH_F32_D64,
    ):
        q = torch.randn((B, Sq, H, D), generator=gen, device="cuda")
        k = torch.randn((B, Sk, G, D), generator=gen, device="cuda")
        v = torch.randn((B, Sk, G, D), generator=gen, device="cuda")
        tag = f"f32[{B}x{Sq}x{Sk},h{H},g{G},d{D}]"
        f32[tag] = _b6_check("lm_dense", tag, q, k, v, causal, FLASH_F32_RTOL, FLASH_F32_ATOL)
    scfg = configs.get_smoke_config("qwen2-1.5b")
    small = transformer.init_params(scfg, gen, device="cuda")
    toks = torch.randint(0, scfg.vocab, (2, 64), generator=gen, device="cuda")
    f32["smoke[2x64,d24]"] = _b6_check(
        "lm_dense", "qwen2 smoke", *layer0_qkv(small, toks), True, FLASH_F32_RTOL, FLASH_F32_ATOL
    )
    report["b6_f32_checks"] = f32
    del small

    # a 2-layer float32 model at full width: kernel route == plain route
    cfg2 = dataclasses.replace(
        cfg, n_layers=2, param_dtype=torch.float32, compute_dtype=torch.float32
    )
    m_kernel = transformer.init_params(cfg2, gen, device="cuda")
    m_plain = transformer.Transformer(dataclasses.replace(cfg2, attn_impl="blockwise"), "cuda")
    m_plain.load_state_dict(m_kernel.state_dict())
    with torch.inference_mode():
        l_kernel, _ = m_kernel.prefill(prompts_by[LM_BATCHES[1][:2]])
        l_plain, _ = m_plain.prefill(prompts_by[LM_BATCHES[1][:2]])
    rel = _rel_l2(l_kernel.float(), l_plain.float())
    report["f32_2layer_logits_rel_l2"] = rel
    print(f"lm_dense: 2-layer f32 last logits, kernel vs plain route: rel L2 {rel:.3g}")
    if not (rel <= LM_RTOL and torch.isfinite(l_kernel).all()):
        raise AssertionError(f"kernel and plain routes disagree: rel L2 {rel:.3g}")
    return report, rows


def phase_lm_zamba(seed: int, card: str) -> tuple[dict, list[dict]]:
    """Zamba-2 LM serving at zamba2-2.7b's published config (54 Mamba-2
    layers, one shared attention block at 9 sites, bf16, random weights
    from a seeded generator on the card): ``LMServer.generate`` on the
    serving batches with B5 = 54 and B6 = 9 launches per prefill; B5's
    (128, 64, 64) build and B6's head-dim-160 builds against their plain
    versions on the path's own operands; a one-site float32 model at full
    width on the kernel and plain routes.  Returns the report and the B5
    and B6 kernel rows."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.launch.serve import LMServer
    from repro_torch.models import transformer, zamba

    t0 = time.perf_counter()
    cfg = configs.get_config("zamba2-2.7b")
    gen = torch.Generator("cuda").manual_seed(seed)
    model = zamba.init_params(cfg, gen, device="cuda")
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"lm_zamba: {cfg.name}: {cfg.num_params()} parameters ({weights / 2**30:.2f} GiB bf16), "
          f"{cfg.n_layers} Mamba-2 layers (d_model {cfg.d_model}, state {cfg.d_state}, "
          f"{cfg.ssm_heads} heads), shared block at {cfg.n_segments} sites (width {cfg.attn_width}, "
          f"{cfg.attn_heads} heads of {cfg.attn_head_dim}) [{card}]")
    report, prompts_by, _ = _serve_lm(
        "lm_zamba", cfg,
        lambda max_len: LMServer(cfg, model, max_len=max_len, device="cuda"),
        gen,
        [(ssd_kernel.ssd_chunked_cuda, cfg.n_layers, ssd_kernel.reset_launches),
         (flash_kernel.flash_fwd_cuda, cfg.n_segments, flash_kernel.reset_launches)],
        card,
    )
    report["weight_bytes"] = weights
    b5_launches = report["kernel_launches"]["ssd_chunked_cuda"]
    b6_launches = report["kernel_launches"]["flash_fwd_cuda"]

    def site0(toks):
        """The first site's q, k, v and layer 0's SSD operands (its input
        is the first site's output) for the prompts ``toks``."""
        with torch.inference_mode():
            B, S = toks.shape
            x0 = model._embed(toks)
            xc = torch.cat([x0, x0], dim=-1)
            q, k, v = model.shared.qkv(xc, model._positions(B, S))
            x1 = model.shared.finish(x0, xc, transformer.causal_attention(cfg, q, k, v))
            return q, k, v, _ssd_launch_args(model.layers[0].ssd_inputs(x1), cfg.chunk)

    # on each serving batch's prompts: B5 on layer 0's operands as the
    # model launches it (batch two's 2 x 1000 padded to 2 x 1024), with
    # its passes from that batch's profiled prefill; B6 on the first
    # site's q, k, v (attention takes S = 1000 unpadded), in bf16 and
    # upcast to float32 (the FMA build)
    rows, report["b6_f32_d160"] = [], {}
    for Bb, S, n_new in LM_BATCHES:
        tag = f"{Bb}x{S}"
        q, k, v, args = site0(prompts_by[(Bb, S)])
        passes = _b5_passes(report["batches"][f"{tag}+{n_new}"]["profile_prefill"], cfg.n_layers)
        rows.append(_b5_row("lm_zamba", f"ssd_chunked[zamba {tag}]", args, cfg.chunk, b5_launches,
                            passes, card))
        rows.append(_b6_row("lm_zamba", f"flash_fwd[zamba {tag},d160]", q, k, v, b6_launches, card))
        report["b6_f32_d160"][tag] = _b6_check(
            "lm_zamba", f"f32 [{tag},d160]", q.float(), k.float(), v.float(), True,
            FLASH_F32_RTOL, FLASH_F32_ATOL, card=card,
        )
        del q, k, v, args
    del model
    torch.cuda.empty_cache()

    # one site at full width in float32: kernel routes == plain routes
    cfg1 = dataclasses.replace(
        cfg, n_layers=cfg.shared_every, param_dtype=torch.float32, compute_dtype=torch.float32
    )
    m_kernel = zamba.init_params(cfg1, gen, device="cuda")
    m_plain = zamba.Zamba(dataclasses.replace(cfg1, ssd_impl="chunked", attn_impl="blockwise"), "cuda")
    m_plain.load_state_dict(m_kernel.state_dict())
    toks = prompts_by[LM_BATCHES[1][:2]]
    with torch.inference_mode():
        l_k, c_k = m_kernel.prefill(toks, max_len=toks.shape[1] + 1)
        l_p, c_p = m_plain.prefill(toks, max_len=toks.shape[1] + 1)
        nxt = l_p.argmax(-1)[:, None]
        d_k, _ = m_kernel.decode_step(c_k, nxt)
        d_p, _ = m_plain.decode_step(c_p, nxt)
    rel_last, rel_dec = _rel_l2(l_k, l_p), _rel_l2(d_k, d_p)
    report["f32_one_site"] = {"last_logits_rel_l2": rel_last, "decode_logits_rel_l2": rel_dec}
    print(f"lm_zamba: one-site f32 model ({cfg1.n_layers} layers) {toks.shape[0]}x{toks.shape[1]}, kernel vs "
          f"plain routes: last logits rel L2 {rel_last:.3g}, one decode step {rel_dec:.3g} "
          f"(<= {LM_RTOL:g}) [{card}]")
    if not (rel_last <= LM_RTOL and rel_dec <= LM_RTOL and torch.isfinite(l_k).all()
            and torch.isfinite(d_k).all()):
        raise AssertionError(f"zamba kernel and plain routes disagree: {report['f32_one_site']}")
    del m_kernel, m_plain, c_k, c_p
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t0
    print(f"lm_zamba: phase {report['seconds']:.1f} s [{card}]")
    return report, rows


def _moe_flops(cfg, B: int, S: int) -> dict:
    """FLOPs of one prefill's MoE layers by part, from the shapes the
    reference's dense dispatch gives them: the dispatch and the combine
    einsums (2·G·gs·E·C·D each), the experts on their capacity buffers
    (3 products of 2·G·E·C·D·Fm) and the shared experts on every token."""
    from repro_torch.models import moe

    T = B * S
    gs = moe.group_size(T, cfg.router_group)
    G = T // gs
    C = max(int(cfg.capacity_factor * gs * cfg.top_k / cfg.n_experts), 1)
    n_moe = cfg.n_layers - cfg.first_k_dense
    slots = G * cfg.n_experts * C
    return {
        "dispatch_combine": n_moe * 2 * 2 * T * cfg.n_experts * C * cfg.d_model,
        "experts": n_moe * 3 * 2 * slots * cfg.d_model * cfg.moe_d_ff,
        "shared": n_moe * 3 * 2 * T * cfg.d_model * cfg.moe_d_ff * cfg.n_shared_experts,
        "capacity": C,
        "groups": G,
    }


def _moe_stages(phase, cfg, mp, h, card) -> dict:
    """One MoE layer's stages on its own input ``h`` (B, S, D), each timed
    alone with CUDA events: the router, the dispatch build, the dispatch
    einsum, the experts, the combine einsum, the shared experts, and the
    whole ``moe_block``."""
    from repro_torch.models import common, moe

    cd = cfg.compute_dtype
    B, S, D = h.shape
    xg = h.reshape(-1, moe.group_size(B * S, cfg.router_group), D)
    with torch.inference_mode():
        probs = torch.softmax(xg.float() @ mp.router, dim=-1)
        dispatch, combine = moe._topk_dispatch(cfg, probs)
        dispatch, combine = dispatch.to(cd), combine.to(cd)
        xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)

        def experts():
            hg = torch.einsum("gecd,edf->gecf", xe, mp.we_gate.to(cd))
            hu = torch.einsum("gecd,edf->gecf", xe, mp.we_up.to(cd))
            return torch.einsum("gecf,efd->gecd", common.swiglu(hg, hu), mp.we_down.to(cd))

        ye = experts()
        stages = {
            "router": lambda: torch.softmax(xg.float() @ mp.router, dim=-1),
            "dispatch build": lambda: moe._topk_dispatch(cfg, probs),
            "dispatch einsum": lambda: torch.einsum("gsec,gsd->gecd", dispatch, xg),
            "experts": experts,
            "combine einsum": lambda: torch.einsum("gsec,gecd->gsd", combine, ye),
        }
        if cfg.n_shared_experts:
            stages["shared"] = lambda: common.swiglu(
                h @ mp.ws_gate.to(cd), h @ mp.ws_up.to(cd)) @ mp.ws_down.to(cd)
        stages["moe_block"] = lambda: moe.moe_block(cfg, mp, h)
        ms = {name: _time_ms(fn, 5) for name, fn in stages.items()}
    print(f"{phase}: {cfg.name} one MoE layer at {B}x{S}, device ms: "
          + ", ".join(f"{n} {t:.3f}" for n, t in ms.items()) + f" [{card}]")
    return ms


@contextlib.contextmanager
def _recorded_routing():
    """Records the router probabilities of every ``moe_block`` call (by
    wrapping ``moe._top_k``) into the list it yields."""
    from repro_torch.models import moe

    rec, orig = [], moe._top_k

    def top_k(probs, k):
        rec.append(probs.detach().clone())
        return orig(probs, k)

    moe._top_k = top_k
    try:
        yield rec
    finally:
        moe._top_k = orig


def _route_differences(rec_a, rec_b, k) -> tuple[int, float]:
    """Tokens whose top-k sets differ between two runs' router
    probabilities, call by call, and the largest such token's gap in
    ``rec_b``'s probabilities (its k-th largest over its probability of
    ``rec_a``'s pick outside its set), relative to that k-th largest."""
    from repro_torch.models import moe

    n, worst = 0, 0.0
    for pa, pb in zip(rec_a, rec_b):
        pa, pb = pa.reshape(-1, pa.shape[-1]), pb.reshape(-1, pb.shape[-1])
        ia, ib = moe._top_k(pa, k)[1], moe._top_k(pb, k)[1]
        member = torch.zeros_like(pb, dtype=torch.bool).scatter_(-1, ib, True)
        extra = torch.zeros_like(member).scatter_(-1, ia, True) & ~member
        rows = extra.any(-1)
        n += int(rows.sum())
        if rows.any():
            kth = pb.gather(-1, ib[:, -1:])[rows, 0]
            low = torch.where(extra, pb, torch.inf)[rows].amin(-1)
            worst = max(worst, float(((kth - low) / kth).max()))
    return n, worst


def _dispatch_on_card(cfg, shape, gen) -> dict:
    """``moe._topk_dispatch`` on the card against the CPU on one (G, gs, E)
    probability tensor with exact ties planted (logits rounded to halves):
    dispatch and combine must be bitwise equal."""
    from repro_torch.models import moe

    logits = torch.round(torch.randn(shape, generator=gen, device="cuda") * 2) / 2
    probs = torch.softmax(logits, dim=-1)
    srt = probs.sort(-1, descending=True).values
    ties = int((srt[..., cfg.top_k - 1] == srt[..., cfg.top_k]).sum())
    d_gpu, c_gpu = moe._topk_dispatch(cfg, probs)
    d_cpu, c_cpu = moe._topk_dispatch(cfg, probs.cpu())
    same = _bits_equal(d_gpu.cpu(), d_cpu) and _bits_equal(c_gpu.cpu(), c_cpu)
    kept = float(d_cpu.sum())
    del d_gpu, c_gpu, d_cpu, c_cpu
    return {"shape": list(shape), "capacity": max(int(cfg.capacity_factor * shape[1] * cfg.top_k
                                                      / cfg.n_experts), 1),
            "ties_at_the_cut": ties, "kept": kept, "bitwise": same}


def phase_lm_moe(seed: int, card: str) -> tuple[dict, list[dict]]:
    """Mixture-of-experts LM serving: deepseek-v2-lite-16b at its published
    config (27 layers, MLA + DeepSeekMoE, 15.71 B parameters, bf16) and
    arctic-480b at its published widths with the depth cut to 2 layers
    (27.68 B parameters, bf16), random weights from a seeded generator on
    the card, each served by ``LMServer.generate`` on the ``lm`` batches
    and freed before the next is built.  DeepSeek's MLA runs the
    reference's blockwise attention (B6 and B5 launch 0 times); Arctic's
    prefill attention runs B6 (n_layers launches per prefill, decode
    none), held against its plain version on layer 0's q, k, v (56 query
    heads over 8 kv heads) of both batches.  A one-layer float32 Arctic
    at full width (8 experts) gives the same last logits and decode step
    by the kernel and blockwise routes; the dispatch on the card is
    bitwise the CPU's.  Returns the report and the B6 kernel rows."""
    from repro_torch import configs
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.launch.serve import LMServer
    from repro_torch.models import common, mla, model_api, moe, transformer

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(seed)
    report, rows = {}, []
    for name, overrides, mod in (("deepseek-v2-lite-16b", {}, mla),
                                 ("arctic-480b", {"n_layers": 2}, moe)):
        cfg = configs.get_config(name, **overrides)
        model = mod.init_params(cfg, gen, device="cuda")
        weights = sum(p.numel() * p.element_size() for p in model.parameters())
        floor_ms = weights / HBM_BYTES_PER_S * 1e3
        print(f"lm_moe: {cfg.name}: {cfg.num_params()} parameters ({weights / 2**30:.2f} GiB bf16), "
              f"{cfg.n_layers} layers ({cfg.first_k_dense} dense), d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads, {cfg.n_experts} experts top-{cfg.top_k} of {cfg.moe_d_ff}"
              + (f", {cfg.n_shared_experts} shared" if cfg.n_shared_experts else "")
              + (f", dense residual {cfg.d_ff}" if cfg.dense_residual else "")
              + f"; decode floor {floor_ms:.3f} ms/token (every weight read once) [{card}]")
        b6_per_prefill = cfg.n_layers if mod is moe else 0
        rep, prompts_by, servers = _serve_lm(
            "lm_moe", cfg,
            lambda max_len, cfg=cfg, model=model: LMServer(cfg, model, max_len=max_len, device="cuda"),
            gen,
            [(flash_kernel.flash_fwd_cuda, b6_per_prefill, flash_kernel.reset_launches),
             (ssd_kernel.ssd_chunked_cuda, 0, ssd_kernel.reset_launches)],
            card,
        )
        rep["weight_bytes"] = weights
        rep["decode_floor_ms"] = floor_ms
        per_token = model_api.model_flops_per_token(cfg, train=False)
        for (Bb, S, n_new), rec in zip(LM_BATCHES, rep["batches"].values()):
            rec["model_flop_share"] = per_token * Bb * S / (rec["prefill_median_ms"] * 1e-3) / BF16_FLOPS
            rec["decode_floor_share"] = floor_ms / rec["decode_ms_per_token"]
            rec["moe_flops"] = _moe_flops(cfg, Bb, S)
            print(f"lm_moe: {cfg.name} {Bb}x{S}: prefill model-FLOP share {rec['model_flop_share']:.2%} "
                  f"(active parameters only, 2 x {cfg.active_params()} a token, of 989 TFLOP/s); "
                  f"decode {rec['decode_ms_per_token']:.3f} ms/token = {rec['decode_floor_share']:.1%} "
                  f"of the weight-bytes floor; dense dispatch + combine einsums "
                  f"{rec['moe_flops']['dispatch_combine'] / 1e12:.2f} TFLOP, experts on capacity "
                  f"buffers (C = {rec['moe_flops']['capacity']}) {rec['moe_flops']['experts'] / 1e12:.2f} "
                  f"TFLOP [{card}]")
        toks = prompts_by[LM_BATCHES[0][:2]]
        with torch.inference_mode():
            last, _ = model.prefill(toks)
            B, S = toks.shape
            pos = torch.arange(S, device="cuda")[None].expand(B, S)
            x = model._embed(toks)
            if mod is mla:  # layer 1, the first MoE layer: its FFN input
                x, _ = model.dense_layers[0].ffn(model.dense_layers[0].full(x, pos)[0])
                blk = model.layers[0]
                h = common.rms_norm(blk.full(x, pos)[0], blk.ln2, cfg.norm_eps)
            else:
                blk = model.layers[0]
                q, k, v = blk.qkv(x, pos)
                x1 = blk.attn_out(x, transformer.causal_attention(cfg, q, k, v))
                h = common.rms_norm(x1, blk.ln3, cfg.norm_eps)
                del q, k, v, x1
        if not torch.isfinite(last).all():
            raise AssertionError(f"{cfg.name}: non-finite prefill logits")
        rep["moe_layer_ms"] = _moe_stages("lm_moe", cfg, blk.moe, h, card)
        del h, x, last
        if mod is moe:
            b6_launches = rep["kernel_launches"]["flash_fwd_cuda"]
            rep["b6_f32"] = {}
            for Bb, S, _ in LM_BATCHES:
                tag = f"{Bb}x{S}"
                with torch.inference_mode():
                    tt = prompts_by[(Bb, S)]
                    q, k, v = blk.qkv(model._embed(tt), torch.arange(S, device="cuda")[None].expand(Bb, S))
                rows.append(_b6_row("lm_moe", f"flash_fwd[arctic {tag},g7]", q, k, v, b6_launches, card))
                rep["b6_f32"][tag] = _b6_check(
                    "lm_moe", f"f32 [arctic {tag},g7]", q.float(), k.float(), v.float(), True,
                    FLASH_F32_RTOL, FLASH_F32_ATOL, card=card,
                )
                del q, k, v
        report[name] = rep
        del model, blk, servers, prompts_by, toks, rep
        torch.cuda.empty_cache()

    # one Arctic layer at full width in float32, 8 experts: the kernel
    # route (B6) and the blockwise route give the same answers and routes
    cfg1 = configs.get_config("arctic-480b", n_layers=1, n_experts=8, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    m_kernel = moe.init_params(cfg1, gen, device="cuda")
    m_plain = moe.MoE(dataclasses.replace(cfg1, attn_impl="blockwise"), "cuda")
    m_plain.load_state_dict(m_kernel.state_dict())
    Bb, S, _ = LM_BATCHES[0]
    toks = torch.randint(0, cfg1.vocab, (Bb, S), generator=gen, device="cuda")
    routes = {}
    for tag, m in (("kernel", m_kernel), ("blockwise", m_plain)):
        with _recorded_routing() as rec, torch.inference_mode():
            last, cache = m.prefill(toks, max_len=S + 1)
            nxt = last.argmax(-1)[:, None] if tag == "kernel" else routes["kernel"][2]
            step, _ = m.decode_step(cache, nxt)
        routes[tag] = (last, step, nxt, rec)
        del cache
    (l_k, d_k, _, r_k), (l_p, d_p, _, r_p) = routes["kernel"], routes["blockwise"]
    rel_last, rel_dec = _rel_l2(l_k, l_p), _rel_l2(d_k, d_p)
    flips, worst = _route_differences(r_k, r_p, cfg1.top_k)
    report["f32_one_layer"] = {"last_logits_rel_l2": rel_last, "decode_logits_rel_l2": rel_dec,
                               "route_differences": flips, "worst_gap_rel": worst}
    print(f"lm_moe: one-layer f32 arctic (8 experts) {Bb}x{S}, kernel vs blockwise routes: last logits "
          f"rel L2 {rel_last:.3g}, one decode step {rel_dec:.3g} (<= {LM_RTOL:g}); tokens routed "
          f"differently {flips} (worst gap {worst:.3g} of the k-th probability, <= {NEAR_TIE_REL:g}) "
          f"[{card}]")
    if not (rel_last <= LM_RTOL and rel_dec <= LM_RTOL and torch.isfinite(l_k).all()
            and torch.isfinite(d_k).all() and worst <= NEAR_TIE_REL):
        raise AssertionError(f"arctic kernel and blockwise routes disagree: {report['f32_one_layer']}")
    del m_kernel, m_plain, routes, r_k, r_p
    torch.cuda.empty_cache()

    # the dispatch on the card, bitwise the CPU's, at each model's
    # 4 x 2048 routing groups
    report["dispatch"] = {}
    for name, shape in (("deepseek-v2-lite-16b", (4, 2048, 64)), ("arctic-480b", (2, 4096, 128))):
        res = report["dispatch"][name] = _dispatch_on_card(configs.get_config(name), shape, gen)
        print(f"lm_moe: {name} dispatch {tuple(shape)} (C = {res['capacity']}, {res['ties_at_the_cut']} "
              f"ties at the top-k cut, {res['kept']:.0f} slots kept) on the card vs the CPU: "
              f"{'bitwise' if res['bitwise'] else 'DIFFERENT'} [{card}]")
        if not res["bitwise"]:
            raise AssertionError(f"{name}: the dispatch on the card differs from the CPU's")
    report["seconds"] = time.perf_counter() - t0
    print(f"lm_moe: phase {report['seconds']:.1f} s [{card}]")
    return report, rows


def _mm_flops(cfg, B: int, S: int) -> float:
    """Model FLOPs of one prefill, 2 x the weights a position runs through
    (attention's own products not counted, as in ``model_flops_per_token``):
    the VLM's N over its Np + S positions; Whisper's encoder layers over the
    T frames and its decoder layers and tied head over the S tokens."""
    if cfg.family == "vlm":
        return 2.0 * cfg.num_params() * B * (cfg.n_patches + S)
    D, F, V, hd = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_heads * cfg.hd
    enc = cfg.n_layers * (4 * D * hd + 2 * D * F)
    dec = cfg.n_layers * (8 * D * hd + 2 * D * F) + V * D
    return 2.0 * B * (enc * cfg.n_frames + dec * S)


def _whisper_sites(model, batch) -> dict:
    """Layer 0's q, k, v at each of Whisper's three B6 sites for one
    batch: the encoder (full, T x T), the decoder's self attention
    (causal, S x S) and its cross attention (full, S x T, k and v from
    the whole encoder's output)."""
    from repro_torch.models import common, transformer

    cfg = model.cfg
    cd = cfg.compute_dtype
    with torch.inference_mode():
        T, D = batch["frames"].shape[1:]
        pe = common.sinusoidal_positions(T, D, device=batch["frames"].device)
        x = batch["frames"].to(cd) + pe.to(cd)[None]  # the encoder's input, as ``encode`` adds it
        layer = model.enc_layers[0]
        h = layer.ln1(x)
        enc = (layer.attn.q(h), *layer.attn.kv(h))
        enc_out = model.encode(batch["frames"])
        x = model._decoder_input(batch["tokens"], 0)
        dl = model.dec_layers[0]
        h = dl.ln1(x)
        dec = (dl.self_attn.q(h), *dl.self_attn.kv(h))
        x = x + dl.self_attn.out(transformer.attention(cfg, *dec, True))
        cross = (dl.cross_attn.q(dl.ln2(x)), *dl.cross_attn.kv(enc_out))
    return {"enc": (enc, False), "dec": (dec, True), "cross": (cross, False)}


def phase_lm_mm(seed: int, card: str) -> tuple[dict, list[dict]]:
    """Whisper-tiny (the audio family) and InternVL2-2B (the VLM) at their
    published configs, bf16, random weights from a seeded generator on
    the card, each served by ``LMServer.generate`` on the ``lm`` batches
    (Whisper: 1500 frames of (B, 1500, 384) beside the tokens; InternVL2:
    256 patches of (B, 256, 2048) ahead of them, its cache sized
    n_patches + S + new) and freed before the next is built.  B6 launches
    per prefill: Whisper 3 x 4 (encoder, decoder self, cross attention at
    its new head-dim-64 build), InternVL2 24 (D = 128); decode none, B5
    none.  B6 is held against its plain version on layer 0's q, k, v of
    every site and batch (bf16: the ``lm_dense`` bounds; float32 within
    1e-5 / 3e-5) and timed; a one-layer float32 model of each at full
    width gives the same last logits and decode step by the kernel and
    blockwise routes (1e-4).  Returns the report and the B6 kernel rows."""
    from repro_torch import configs
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.launch.serve import LMServer
    from repro_torch.models import model_api

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(seed)
    report, rows = {}, []
    for name in ("whisper-tiny", "internvl2-2b"):
        cfg = configs.get_config(name)
        mod = model_api.get_model(cfg)
        model = mod.init_params(cfg, gen, device="cuda")
        audio = cfg.family == "audio"
        weights = sum(p.numel() * p.element_size() for p in model.parameters())
        print(f"lm_mm: {cfg.name}: {cfg.num_params()} parameters ({weights / 2**30:.2f} GiB bf16), "
              + (f"{cfg.n_layers} + {cfg.n_layers} layers, {cfg.n_frames} frames, " if audio
                 else f"{cfg.n_layers} layers, {cfg.n_patches} patches, ")
              + f"d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} of {cfg.hd} [{card}]")

        def prompt_for(Bb, S, cfg=cfg, audio=audio):
            width = cfg.n_frames if audio else cfg.n_patches
            return {
                "tokens": torch.randint(0, cfg.vocab, (Bb, S), generator=gen, device="cuda"),
                "frames" if audio else "patches": torch.randn(
                    (Bb, width, cfg.d_model), generator=gen, device="cuda"),
            }

        extra = 0 if audio else cfg.n_patches  # the VLM's cache holds the patches too
        b6_per_prefill = 3 * cfg.n_layers if audio else cfg.n_layers
        rep, prompts_by, servers = _serve_lm(
            "lm_mm", cfg,
            lambda max_len, cfg=cfg, model=model, extra=extra: LMServer(
                cfg, model, max_len=extra + max_len, device="cuda"),
            gen,
            [(flash_kernel.flash_fwd_cuda, b6_per_prefill, flash_kernel.reset_launches),
             (ssd_kernel.ssd_chunked_cuda, 0, ssd_kernel.reset_launches)],
            card, prompt_for=prompt_for,
        )
        rep["weight_bytes"] = weights
        for (Bb, S, n_new), rec in zip(LM_BATCHES, rep["batches"].values()):
            rec["model_flops"] = _mm_flops(cfg, Bb, S)
            rec["model_flop_share"] = rec["model_flops"] / (rec["prefill_median_ms"] * 1e-3) / BF16_FLOPS
            print(f"lm_mm: {cfg.name} {Bb}x{S}: prefill model-FLOP share {rec['model_flop_share']:.2%} "
                  f"({rec['model_flops'] / 1e12:.3f} TFLOP: 2 x weights a position, attention not "
                  f"counted, of 989 TFLOP/s) [{card}]")
        b6_launches = rep["kernel_launches"]["flash_fwd_cuda"]
        rep["b6_f32"] = {}
        for Bb, S, _ in LM_BATCHES:
            batch = prompts_by[(Bb, S)]
            with torch.inference_mode():
                last, _ = model.prefill(batch)
            if not torch.isfinite(last).all():
                raise AssertionError(f"{cfg.name}: non-finite prefill logits")
            if audio:
                sites = _whisper_sites(model, batch)
            else:
                with torch.inference_mode():
                    x = model._inputs(batch)
                    sites = {"": (model.layers[0].qkv(x, model._positions(*x.shape[:2])), True)}
            for site, ((q, k, v), causal) in sites.items():
                Sq, Sk = q.shape[1], k.shape[1]
                if audio:
                    tag = f"whisper {site} {Bb}x{Sq}" + (f"x{Sk}" if Sk != Sq else "") + f",d{cfg.hd}"
                else:
                    tag = f"internvl2 {Bb}x{Sq},g{cfg.n_heads // cfg.n_kv_heads}"
                rows.append(_b6_row("lm_mm", f"flash_fwd[{tag}]", q, k, v, b6_launches, card, causal))
                rep["b6_f32"][tag] = _b6_check(
                    "lm_mm", f"f32 [{tag}]", q.float(), k.float(), v.float(), causal,
                    FLASH_F32_RTOL, FLASH_F32_ATOL, card=card,
                )
                del q, k, v
            del sites, last
        report[name] = rep
        del model, servers, prompts_by, rep
        torch.cuda.empty_cache()

        # one layer at full width in float32: kernel route == blockwise route
        cfg1 = dataclasses.replace(cfg, n_layers=1, param_dtype=torch.float32,
                                   compute_dtype=torch.float32)
        m_kernel = mod.init_params(cfg1, gen, device="cuda")
        m_plain = type(m_kernel)(dataclasses.replace(cfg1, attn_impl="blockwise"), "cuda")
        m_plain.load_state_dict(m_kernel.state_dict())
        Bb, S, _ = LM_BATCHES[1]
        batch = prompt_for(Bb, S)
        M = extra + S + 1
        with torch.inference_mode():
            l_k, c_k = m_kernel.prefill(batch, max_len=M)
            l_p, c_p = m_plain.prefill(batch, max_len=M)
            nxt = l_p.argmax(-1)[:, None]
            d_k, _ = m_kernel.decode_step(c_k, nxt)
            d_p, _ = m_plain.decode_step(c_p, nxt)
        rel_last, rel_dec = _rel_l2(l_k, l_p), _rel_l2(d_k, d_p)
        report[name]["f32_one_layer"] = {"last_logits_rel_l2": rel_last, "decode_logits_rel_l2": rel_dec}
        print(f"lm_mm: one-layer f32 {cfg.name} {Bb}x{S}, kernel vs blockwise routes: last logits "
              f"rel L2 {rel_last:.3g}, one decode step {rel_dec:.3g} (<= {LM_RTOL:g}) [{card}]")
        if not (rel_last <= LM_RTOL and rel_dec <= LM_RTOL and torch.isfinite(l_k).all()
                and torch.isfinite(d_k).all()):
            raise AssertionError(f"{cfg.name} kernel and blockwise routes disagree: "
                                 f"{report[name]['f32_one_layer']}")
        del m_kernel, m_plain, c_k, c_p, batch
        torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t0
    print(f"lm_mm: phase {report['seconds']:.1f} s [{card}]")
    return report, rows


def _conv_row(tag, x, w, launches, rtol, reps=20, want_route=None) -> dict:
    """One B4 ``kernel:`` row: the kernel ``kernel.route`` names (and, if
    given, it must be ``want_route``) against its plain version on the
    same inputs (bf16 inputs upcast to float32 for the plain version),
    then both timed with CUDA events.  The plain version is one cuDNN
    ``F.conv3d`` call (TF32 off), so its time is also the library time.
    Bound: bf16 at the bf16 tensor-core rate; float32 at the TF32 rate / 3
    (3xTF32 keeps float32 accuracy), the FMA pipes' bound beside it."""
    from repro_torch.kernels.conv3d import kernel as conv_kernel
    from repro_torch.kernels.conv3d import ref as conv_ref

    route = conv_kernel.route(tuple(x.shape), tuple(w.shape), x.dtype)
    if want_route is not None and route != want_route:
        raise AssertionError(f"B4 {tag} routed to {route}, not {want_route}")
    got = conv_kernel.conv3d_cuda(x, w).float()
    want = conv_ref.conv3d_ref(x.float(), w.float())
    rel = _rel_l2(got, want)
    mx = float(torch.max(torch.abs(got - want)))
    shape = dict(x_shape=tuple(x.shape), w_shape=tuple(w.shape), dtype=x.dtype)
    bound, by = _kernel_bound("conv3d", **shape)
    bound_fma = None if x.dtype == torch.bfloat16 else _kernel_bound("conv3d", roofline.PEAK_FLOPS_F32, **shape)[0]
    print(
        f"classify: B4 {tag} x {tuple(x.shape)} w {tuple(w.shape)} {x.dtype} route {route} vs plain: "
        f"rel L2 {rel:.3g}, max abs {mx:.3g}; bound {bound:.4f} ms ({by})"
        + ("" if bound_fma is None else f" at TF32 / 3, float32 FMA {bound_fma:.4f}")
    )
    if not (rel <= rtol and torch.isfinite(got).all()):
        raise AssertionError(f"B4 {tag} disagrees with its plain version (rel L2 {rel:.3g})")
    del got, want
    ms = _time_ms(lambda: conv_kernel.conv3d_cuda(x, w), reps)
    plain_ms = _time_ms(lambda: conv_ref.conv3d_ref(x, w), max(3, reps // 4))
    source = {"wgmma": "conv3d_tc.cu", "igemm": "conv3d_igemm.cu", "fma": "conv3d.cu"}[route]
    return {
        "name": f"conv3d{tag}",
        "route": "cuda",
        "b4_route": route,
        "source": f"src/repro_torch/kernels/conv3d/csrc/{source}",
        "replaces": "src/repro/kernels/conv3d/kernel.py:41",
        "launches": launches,
        "max_abs_err": mx,
        "max_err": mx,
        "rel_l2": rel,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "bound_f32_fma_ms": bound_fma,
        "library_ms": plain_ms,
        "shape": {"x": list(x.shape), "w": list(w.shape), "dtype": str(x.dtype).removeprefix("torch.")},
    }


def _ties(logits: torch.Tensor) -> torch.Tensor:
    """Rows whose top-two logits lie within ``TIE`` of their scale."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) <= TIE * torch.amax(torch.abs(logits), dim=-1)


def _same_classes(what, got, want, logits) -> int:
    """Class predictions must match outside the near-ties of ``logits``;
    returns the tie count."""
    ties = _ties(logits).cpu().numpy()
    got, want = np.asarray(got), np.asarray(want)
    if not np.array_equal(got[~ties], want[~ties]):
        bad = int(np.sum((got != want) & ~ties))
        raise AssertionError(f"{what}: {bad} predictions differ outside near-ties")
    print(f"classify: {what}: {len(got)} predictions equal outside {int(ties.sum())} near-ties")
    return int(ties.sum())


def _profile_steady(fn, reps: int = 5) -> dict:
    """``_profile`` for calls of a few ms: the profiler skips one call and
    discards a warm-up call (its first activity records can be lost), then
    records ``reps`` calls; times are per call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=reps)) as prof:
        for i in range(2 + reps):
            if i == 2:
                t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof.step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    return _device_time(prof, wall_ms, reps)


def _timed(fn, batches) -> list[float]:
    """One warm-up call, then one timed call per batch (host clock around
    a call that ends in a host copy)."""
    fn(batches[0])
    torch.cuda.synchronize()
    lat = []
    for b in batches[1 : 1 + CLASSIFY_REPS]:
        t0 = time.perf_counter()
        fn(b)
        lat.append(time.perf_counter() - t0)
    return lat


def phase_classify(seed: int, stmul_kernel) -> tuple[dict, list[dict]]:
    """The paper's hybrid 3-D CNN at its full geometry (60x80x16 clips, 9
    kernels of 30x40x8, pool (8, 8, 3), hidden 128, 4 classes), random
    weights from a seeded generator on the card, on the synthetic-KTH
    test split; returns the report and the B4 and B1 kernel rows."""
    from repro_torch.configs import sthc_kth
    from repro_torch.core import hybrid, spectral_conv
    from repro_torch.data import kth_synthetic as kth
    from repro_torch.kernels.conv3d import kernel as conv_kernel
    from repro_torch.kernels.stmul import ref as stmul_ref
    from repro_torch.launch.serve import HybridClassifierServer

    cfg = sthc_kth.config()
    gen = torch.Generator("cuda").manual_seed(seed)
    params = hybrid.init_params(cfg, gen, device="cuda")
    x_test, y_test = kth.make_split("test")
    batches = [x_test[i : i + CLASSIFY_BATCH] for i in range(0, len(y_test), CLASSIFY_BATCH)]
    streams = np.stack([
        kth.render_clip(label, 17, 0, kth.VideoSpec(60, 80, STREAM_FRAMES))[None]
        for label in range(4)
    ])
    report = {"config": dataclasses.asdict(cfg) | {"dtype": "float32"}, "clips": len(y_test),
              "batch": CLASSIFY_BATCH, "stream_frames": STREAM_FRAMES, "routes": {}}

    def predict(impl):
        return lambda b: hybrid.predict(params, b, cfg, impl=impl).cpu().numpy()

    # the main path, counted: kernel launch counters at 0 just before it
    conv_kernel.reset_launches()
    stmul_kernel.reset_launches()
    digital_calls = 0
    with torch.no_grad():
        servers = {
            "server_physical": HybridClassifierServer(params, cfg, physical=True),
            "server_ideal": HybridClassifierServer(params, cfg, physical=False),
        }
        routes = {impl: predict(impl) for impl in ("digital", "spectral", "sthc_physical")}
        routes |= {name: srv.classify for name, srv in servers.items()}
        # every route over the whole split; digital and spectral logits kept
        logits = {
            impl: torch.cat([hybrid.forward(params, b, cfg, impl=impl) for b in batches])
            for impl in ("digital", "spectral")
        }
        digital_calls += len(batches)
        preds = {impl: lg.argmax(-1).cpu().numpy() for impl, lg in logits.items()}
        for name in ("sthc_physical", "server_physical", "server_ideal"):
            preds[name] = np.concatenate([routes[name](b) for b in batches])
        for name, p in preds.items():
            report["routes"][name] = {"accuracy": float(np.mean(p == y_test))}
        report["digital_vs_spectral_ties"] = _same_classes(
            "digital vs spectral", preds["digital"], preds["spectral"], logits["digital"]
        )
        report["server_ideal_vs_spectral_ties"] = _same_classes(
            "server ideal vs predict(spectral)", preds["server_ideal"], preds["spectral"],
            logits["spectral"],
        )
        # batch latency per route
        for name, fn in routes.items():
            lat = _timed(fn, batches)
            digital_calls += (1 + len(lat)) * (name == "digital")
            med = float(np.median(lat))
            report["routes"][name] |= {"latency_s": lat, "median_ms": med * 1e3,
                                       "clips_per_s": CLASSIFY_BATCH / med}
            print(
                f"classify: {name:15s} median {med * 1e3:8.3f} ms (min {min(lat) * 1e3:.3f}, "
                f"max {max(lat) * 1e3:.3f}, n={len(lat)})  {CLASSIFY_BATCH / med:10.1f} clips/s  "
                f"accuracy {report['routes'][name]['accuracy']:.4f} (random weights)"
            )
        # the pinned-copy rider: host clips staged through pinned buffers
        # (the routes above) against the pageable copy they replace, in
        # turns (pageable, pinned, pinned, pageable)
        report["pinned_vs_pageable"] = {}
        for impl in ("digital", "spectral"):
            def pageable(b, impl=impl):
                x = torch.from_numpy(b).to("cuda")
                return hybrid.predict(params, x, cfg, impl=impl).cpu().numpy()

            lat = {"pageable": [], "pinned": []}
            for kind in ("pageable", "pinned", "pinned", "pageable"):
                got = _timed(pageable if kind == "pageable" else routes[impl], batches)
                lat[kind] += got
                digital_calls += (1 + len(got)) * (impl == "digital")
            meds = {k: float(np.median(v)) * 1e3 for k, v in lat.items()}
            report["pinned_vs_pageable"][impl] = {"median_ms": meds, "latency_s": lat}
            print(f"classify: {impl:8s} clips pinned median {meds['pinned']:.3f} ms vs pageable "
                  f"{meds['pageable']:.3f} ms (n={len(lat['pinned'])} each, in turns)")
        ratio = report["routes"]["digital"]["median_ms"] / report["routes"]["spectral"]["median_ms"]
        report["digital_vs_spectral_ratio"] = ratio
        print(f"classify: digital / spectral median batch latency {ratio:.3f}")
        # long clips: 4 streams of STREAM_FRAMES, one per class
        srv = servers["server_ideal"]
        seg_preds = srv.classify_stream(streams)
        ot = cfg.conv_out_shape[2]
        n_seg = seg_preds.shape[1]
        seg_ties = 0
        for s in range(n_seg):
            sub = streams[..., s * ot : s * ot + cfg.frames]
            one = srv.classify(sub)
            ties = _ties(hybrid.forward(params, sub, cfg, impl="sthc_ideal")).cpu().numpy()
            if not np.array_equal(seg_preds[:, s][~ties], one[~ties]):
                raise AssertionError(f"classify_stream segment {s} != classify of its sub-clip")
            seg_ties += int(ties.sum())
        report["stream_segments"] = n_seg
        report["stream_segment_ties"] = seg_ties
        print(f"classify: classify_stream: {n_seg} segments x 4 streams equal classify of "
              f"their sub-clips outside {seg_ties} near-ties")
        conv_d = hybrid.conv_layer_stream(params, streams, cfg, impl="digital")
        conv_s = hybrid.conv_layer_stream(params, streams, cfg, impl="spectral")
        digital_calls += 1
        err = float(torch.max(torch.abs(conv_d - conv_s)) / torch.max(torch.abs(conv_d)))
        report["stream_digital_vs_ideal_max_rel"] = err
        print(f"classify: streamed digital (B4) vs streamed ideal STHC conv: max err / max "
              f"{err:.3g} (bound {STREAM_RTOL:g})")
        if not err <= STREAM_RTOL:
            raise AssertionError(f"streamed digital vs ideal conv differ by {err:.3g}")
        del conv_d, conv_s
        stream_jobs = {
            "classify_stream_physical": lambda s: servers["server_physical"].classify_stream(s),
            "classify_stream_ideal": lambda s: servers["server_ideal"].classify_stream(s),
            "conv_layer_stream_digital": lambda s: (
                hybrid.conv_layer_stream(params, s, cfg, impl="digital"), torch.cuda.synchronize()),
        }
        for name, fn in stream_jobs.items():
            lat = _timed(fn, [streams] * (1 + CLASSIFY_REPS))
            digital_calls += (1 + len(lat)) * (name == "conv_layer_stream_digital")
            med = float(np.median(lat))
            report["routes"][name] = {"latency_s": lat, "median_ms": med * 1e3,
                                      "frames_per_s": 4 * STREAM_FRAMES / med}
            print(f"classify: {name:26s} median {med * 1e3:9.3f} ms (min {min(lat) * 1e3:.3f}, "
                  f"max {max(lat) * 1e3:.3f}, n={len(lat)})  {4 * STREAM_FRAMES / med:10.1f} frames/s")
        torch.cuda.synchronize()
    b4 = conv_kernel.conv3d_cuda.launches
    b1 = stmul_kernel.spectral_mac_cuda.launches
    report["launches"] = {"conv3d": b4, "spectral_mac": b1, "digital_calls": digital_calls}
    print(f"classify: launches conv3d {b4} (digital calls {digital_calls}), spectral_mac {b1}")
    if b4 != digital_calls:
        raise AssertionError(f"B4 launched {b4} times for {digital_calls} digital calls")
    if b1 <= 0:
        raise AssertionError("B1 was not launched by the STHC routes")

    # where the time goes: five profiled calls of each route
    with torch.no_grad():
        for name, fn in routes.items():
            prof = _profile_steady(lambda fn=fn: fn(batches[0]))
            report["routes"][name]["profile"] = prof
            busy = ("not measured" if prof["busy_share"] is None
                    else f"{prof['device_ms']:.3f} ms ({prof['busy_share']:.1%})")
            print(f"profile: classify {name:15s} wall {prof['wall_ms']:.3f} ms, device busy {busy}")
            for kn, ms in prof["top_kernels_ms"]:
                print(f"profile:   {ms:9.3f} ms  {kn}")

    # B4 rows: the phase's two shapes (the batch and the streams with this
    # run's weights), kernels_bench's C3D case in float32 and bf16, and
    # the reference test sweep's shapes
    w = params.conv_w.detach()
    xb, xs = torch.from_numpy(batches[0]).cuda(), torch.from_numpy(streams).cuda()
    rows = [
        _conv_row(f"[{xb.shape[0]}x{'x'.join(map(str, xb.shape[2:]))}]", xb, w, b4, CONV_RTOL,
                  want_route="wgmma"),
        _conv_row(f"[{xs.shape[0]}x{'x'.join(map(str, xs.shape[2:]))}]", xs, w, b4, CONV_RTOL,
                  reps=5, want_route="wgmma"),
    ]
    del xb, xs
    xc = torch.randn((1, 16, 14, 14, 8), generator=gen, device="cuda")
    wc = torch.randn((16, 16, 3, 3, 3), generator=gen, device="cuda")
    rows.append(_conv_row("_c3d[f32]", xc, wc, b4, CONV_RTOL))
    rows.append(_conv_row("_c3d[bf16]", xc.bfloat16(), wc.bfloat16(), b4, CONV_BF16_RTOL))
    for b, c, o, k, h, t in CONV_SWEEP:
        xs = torch.randn((b, c, h, h + 2, t), generator=gen, device="cuda")
        ws = torch.randn((o, c, k, k, min(k, t)), generator=gen, device="cuda")
        rows.append(_conv_row(f"_sweep[{b}x{c}x{h}x{h + 2}x{t},o{o},k{k}]", xs, ws, b4, CONV_RTOL))

    # B1 at the classifier's shapes: the batch's spectra against a 9-kernel
    # grating on the 60x80x16 clip's FFT grid
    fft = spectral_conv.fft_shape_for((60, 80, 16), (30, 40, 8))
    F = fft[0] * fft[1] * (fft[2] // 2 + 1)

    def cplx(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device="cuda"),
                             torch.randn(shape, generator=gen, device="cuda"))

    xh, gr = cplx(CLASSIFY_BATCH, 1, F), cplx(9, 1, F)
    with spectral_conv.full_precision():
        got = stmul_kernel.spectral_mac_cuda(xh, gr, 2)
        want = stmul_ref.spectral_mac_ref(xh, gr, 2)
        mx = float(torch.max(torch.abs(got - want)))
        bitwise = _bits_equal(torch.view_as_real(got), torch.view_as_real(want))
        print(f"classify: B1 x {tuple(xh.shape)} grating {tuple(gr.shape)} vs plain: "
              f"{'bitwise' if bitwise else 'DIFFERS'}, max abs {mx:.3g}")
        if not bitwise:
            raise AssertionError(f"B1 at the classifier's shapes differs from its plain version (max abs {mx:.3g})")
        ms = _time_ms(lambda: stmul_kernel.spectral_mac_cuda(xh, gr, 2), 20)
        plain_ms = _time_ms(lambda: stmul_ref.spectral_mac_ref(xh, gr, 2), 3)
        lib_ms = _time_ms(lambda: torch.einsum("bcf,ocf->bof", xh, gr), 20)
    bound, by = _kernel_bound("spectral_mac", B=CLASSIFY_BATCH, O=9, C=1, F=F)
    rows.append({
        "name": "spectral_mac[classify]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/stmul/csrc/stmul.cu",
        "replaces": "src/repro/kernels/stmul/kernel.py:147",
        "launches": b1,
        "max_abs_err": mx,
        "max_err": mx,
        "bitwise": bitwise,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": lib_ms,
        "shape": {"B": CLASSIFY_BATCH, "O": 9, "C": 1, "F": F},
    })
    return report, rows


def phase_c3d(seed: int, card: str) -> tuple[dict, list[dict]]:
    """C3D at its published widths on B4's ``igemm`` route, at the
    benchmark cell's 128 clips a call; returns the report and a
    ``kernel:`` row per layer."""
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.core.spectral_conv import full_precision
    from repro_torch.kernels.conv3d import kernel as conv_kernel
    from repro_torch.kernels.conv3d import ref as conv_ref
    from repro_torch.launch.serve import C3DClassifierServer
    from repro_torch.models import c3d

    sys.path.insert(0, os.path.join(ROOT, "portbench"))
    from pbench import c3d_cost  # the cell's yardstick: b4_roofline divides these bounds

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config("c3d-sports1m")
    with open(os.path.join(ROOT, "portbench", "configs", "c3d-sports1m.json")) as fh:
        m = json.load(fh)["model"]
    layers = c3d_cost.convs(m)  # (name, C, O, H, W, T), the border's output = input extent
    if [tuple(layer[:3]) for layer in layers] != [tuple(c) for c in cfg.convs()]:
        raise AssertionError("the benchmark's C3D layers differ from configs.c3d_sports1m")
    gen = torch.Generator("cuda").manual_seed(seed)
    B = C3D_BATCH
    report = {"batch": B, "layers": {}}

    # the served call, counted: one warm-up, C3D_REPS timed, then one call
    # with B4's counters at 0 just before it
    params = c3d.init_params(cfg, gen, device="cuda")
    server = C3DClassifierServer(params, device="cuda")
    clips = torch.rand((B, cfg.in_channels, cfg.height, cfg.width, cfg.frames), generator=gen, device="cuda")
    server.classify(clips)
    lat = []
    for _ in range(C3D_REPS):
        t1 = time.perf_counter()
        server.classify(clips)
        lat.append(time.perf_counter() - t1)
    conv_kernel.reset_launches()
    server.classify(clips)
    by_route = dict(conv_kernel.conv3d_cuda.route_launches)
    med = float(np.median(lat))
    report |= {"classify_latency_s": lat, "frames_per_s": B * cfg.frames / med, "route_launches": by_route,
               "peak_bytes": torch.cuda.max_memory_allocated()}
    print(f"c3d: classify {B} clips median {med * 1e3:.2f} ms (n={len(lat)}), "
          f"{B * cfg.frames / med:.1f} frames/s; B4 launches by route {by_route} [{card}]")
    if by_route != {"wgmma": 0, "igemm": len(layers), "fma": 0}:
        raise AssertionError(f"C3D's classify launched B4 {by_route}, want igemm {len(layers)} and no other")
    del server, params, clips
    torch.cuda.empty_cache()

    # each layer as the trunk calls it: channels-last, border 1, bias, ReLU
    # (conv1a reads the clips through a channels-last view, as the trunk does)
    rows = []
    for name, C, O, H, W, T in layers:
        shape = (B, C, H, W, T) if C == cfg.in_channels else (B, H, W, T, C)
        x = torch.rand(shape, generator=gen, device="cuda")
        x = x.permute(0, 2, 3, 4, 1) if C == cfg.in_channels else x
        w = torch.randn((O, C, 3, 3, 3), generator=gen, device="cuda") * (2.0 / (C * 27)) ** 0.5
        b = torch.randn((O,), generator=gen, device="cuda") * 0.01
        opts = dict(pad=1, bias=b, relu=True, channels_last=True)
        route = conv_kernel.route((B, C, H + 2, W + 2, T + 2), tuple(w.shape), x.dtype)
        if route != "igemm":
            raise AssertionError(f"B4 C3D {name} routed to {route}, not igemm")
        xn = x.permute(0, 4, 1, 2, 3)  # (B, C, H, W, T) view for cuDNN

        def library(xn=xn, w=w, b=b):  # one cuDNN call and ReLU in place, TF32 off
            with full_precision():
                return F.conv3d(xn, w, b, padding=1).relu_()

        got = conv_kernel.conv3d_cuda(x, w, **opts)
        want = conv_ref.conv3d_ref(x, w, **opts)
        rel = _rel_l2(got, want)
        mx = float(torch.max(torch.abs(got - want)))
        finite = bool(torch.isfinite(got).all())
        del got
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            one_pass = F.conv3d(xn, w, b, padding=1).relu_().permute(0, 2, 3, 4, 1)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        rel_tf32 = _rel_l2(one_pass, want)
        del one_pass, want
        flops, nbytes = c3d_cost.conv_cost(B, C, O, H, W, T, 3)
        bound_s = max(flops / c3d_cost.PEAK_TF32, nbytes / c3d_cost.HBM_BW)
        by = "bytes" if nbytes / c3d_cost.HBM_BW >= flops / c3d_cost.PEAK_TF32 else "operations"
        bound3_s = max(3 * flops / c3d_cost.PEAK_TF32, nbytes / c3d_cost.HBM_BW)
        print(f"c3d: B4 {name} x {tuple(x.shape)} w {tuple(w.shape)} route igemm vs plain: rel L2 {rel:.3g} "
              f"(one TF32 pass {rel_tf32:.3g}; bound {CONV_RTOL:g}), max abs {mx:.3g} [{card}]")
        if not (rel <= CONV_RTOL and finite):
            raise AssertionError(f"B4 C3D {name} disagrees with its plain version (rel L2 {rel:.3g})")
        if not rel_tf32 > CONV_RTOL:
            raise AssertionError(f"one TF32 pass meets the bound at {name} ({rel_tf32:.3g}): it tells nothing")
        ms = _time_ms(lambda: conv_kernel.conv3d_cuda(x, w, **opts), 5)
        plain_ms = _time_ms(lambda: conv_ref.conv3d_ref(x, w, **opts), 3)
        lib_ms = _time_ms(library, 3)
        share = bound_s * 1e3 / ms
        print(f"c3d: B4 {name} {ms:.3f} ms, plain {plain_ms:.3f}, library (cuDNN, TF32 off) {lib_ms:.3f}; "
              f"bound {bound_s * 1e3:.3f} ms ({by}, TF32 dense), {bound3_s * 1e3:.3f} at three passes; "
              f"roofline {share:.1%} [{card}]")
        report["layers"][name] = {"rel_l2": rel, "rel_l2_one_tf32_pass": rel_tf32, "ms": ms, "plain_ms": plain_ms,
                                  "library_ms": lib_ms, "bound_ms": bound_s * 1e3, "roofline": share}
        rows.append({
            "name": f"conv3d_c3d_{name}[{B}]",
            "route": "cuda",
            "b4_route": route,
            "source": "src/repro_torch/kernels/conv3d/csrc/conv3d_igemm.cu",
            "replaces": "src/repro/kernels/conv3d/kernel.py:41",
            "launches": by_route["igemm"],
            "max_abs_err": mx,
            "max_err": mx,
            "rel_l2": rel,
            "ms": ms,
            "kernel_ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3,
            "bound_by": by,
            "bound_3xtf32_ms": bound3_s * 1e3,
            "library_ms": lib_ms,
            "shape": {"x": list(x.shape), "w": list(w.shape), "dtype": "float32", "pad": 1,
                      "bias": True, "relu": True, "channels_last": True},
        })
        del x, xn, w, b
        torch.cuda.empty_cache()
    total = sum(r["ms"] for r in rows)
    bound = sum(r["bound_ms"] for r in rows)
    report["conv_ms"], report["bound_ms"] = total, bound
    report["seconds"] = time.perf_counter() - t0
    print(f"c3d: eight layers {total:.2f} ms a call against a bound of {bound:.2f} ms ({bound / total:.1%}); "
          f"phase {report['seconds']:.1f} s [{card}]")
    return report, rows


def _step_grads(hybrid, params, batch, cfg, impl) -> dict[str, torch.Tensor]:
    """Each parameter's gradient of the batch loss on one route."""
    named = dict(params.named_parameters())
    loss, _ = hybrid.loss_fn(params, batch, cfg, impl=impl)
    return dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


def _timed_steps(steps, n: int) -> tuple[list[float], list]:
    """Host seconds of the first ``n`` steps of a ``train_steps``
    iterator, each ended by ``torch.cuda.synchronize()``, and every
    step's aux."""
    times, auxes = [], []
    t0 = time.perf_counter()
    for i, aux in steps:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        auxes.append(aux)
        t0 = t1
        if i + 1 == n:
            break
    return times, auxes


def _bench_ablation() -> dict[str, float]:
    """The reference's committed ablation accuracies (``BENCH_ablation.json``)."""
    with open(os.path.join(ROOT, "BENCH_ablation.json")) as fh:
        rows = json.load(fh)["rows"]
    return {r["name"]: float(r["derived"].split(";")[0].removeprefix("acc="))
            for r in rows if r["name"].startswith("ablation_") and r["name"] != "ablation_cache"}


def phase_train(seed: int, stmul_kernel) -> tuple[dict, list[dict]]:
    """Train the paper's hybrid 3-D CNN at its full geometry on the card
    (45 epochs of 32 on ``spectral``, from a seeded init), then evaluate
    it on every backend and sweep the fidelity ablation; returns the
    report and B4's row at the training batch."""
    from repro_torch.configs import sthc_kth
    from repro_torch.core import fidelity, hybrid
    from repro_torch.data import kth_synthetic as kth
    from repro_torch.kernels.conv3d import kernel as conv_kernel
    from repro_torch.kernels.conv3d import ops as conv_ops
    from repro_torch.kernels.conv3d import ref as conv_ref
    from repro_torch.launch import train_hybrid as th

    t_phase = time.perf_counter()
    cfg = sthc_kth.config()
    params = hybrid.init_params(cfg, torch.Generator("cuda").manual_seed(seed), device="cuda")
    x_train, y_train = kth.make_split("train")
    first = next(kth.batches(x_train, y_train, TRAIN_BATCH, np.random.RandomState(0)))
    batch = {"video": torch.from_numpy(first["video"]).cuda(),
             "label": torch.from_numpy(first["label"]).cuda()}
    shapes = (tuple(batch["video"].shape), tuple(params.conv_w.shape))
    route = conv_kernel.route(*shapes, torch.float32)
    plan = conv_kernel.tc_plan(*shapes) if route == "wgmma" else conv_kernel.plan(*shapes)
    report = {"batch": TRAIN_BATCH, "epochs": TRAIN_EPOCHS, "seed": seed,
              "b4_route_at_batch": route, "b4_plan_at_batch": dataclasses.asdict(plan)}
    print(f"train: B4 at batch {TRAIN_BATCH}: route {report['b4_route_at_batch']}, "
          f"plan {report['b4_plan_at_batch']}")

    # one digital step (B4 forward, plain backward) against one spectral
    # step from the same parameters and batch: each gradient
    g_dig = _step_grads(hybrid, params, batch, cfg, "digital")
    g_spec = _step_grads(hybrid, params, batch, cfg, "spectral")
    rels = {name: _rel_l2(g_dig[name], g_spec[name]) for name in g_dig}
    report["digital_vs_spectral_grad_rel_l2"] = rels
    print("train: digital vs spectral gradients, relative L2: "
          + ", ".join(f"{k} {v:.3g}" for k, v in rels.items()) + f" (bound {TRAIN_GRAD_RTOL:g})")
    if not all(v <= TRAIN_GRAD_RTOL for v in rels.values()):
        raise AssertionError(f"digital and spectral gradients differ: {rels}")
    del g_dig, g_spec
    # B4's autograd (kernel forward, plain backward) against autograd of
    # the plain version, on a loss that feeds the forward back (g = y)
    b4 = {}
    for name, fn in (("b4", conv_ops.conv3d), ("plain", conv_ref.conv3d_ref)):
        x = batch["video"].clone().requires_grad_()
        w = params.conv_w.detach().clone().requires_grad_()
        y = fn(x, w)
        b4[name] = torch.autograd.grad(0.5 * torch.sum(y * y), [x, w])
    rel_b4 = {k: _rel_l2(a, b) for k, a, b in zip(("x", "w"), b4["b4"], b4["plain"])}
    report["b4_autograd_rel_l2"] = rel_b4
    print(f"train: B4 autograd vs plain autograd: dx {rel_b4['x']:.3g}, dw {rel_b4['w']:.3g} "
          f"(bound {CONV_RTOL:g})")
    if not all(v <= CONV_RTOL for v in rel_b4.values()):
        raise AssertionError(f"B4's gradients differ from the plain version's: {rel_b4}")
    del b4
    # the STHC routes are inference-only: B1 refuses a graph
    try:
        hybrid.loss_fn(params, batch, cfg, impl="sthc_physical")
    except ValueError as e:
        if "no backward" not in str(e):
            raise
        report["b1_grad_guard"] = str(e)
        print(f"train: sthc_physical in grad mode raises: {e}")
    else:
        raise AssertionError("B1 ran in grad mode on an input that requires a gradient")

    # the median step on each route, 10 steps of a throwaway model each,
    # then 5 more profiled
    for impl in ("digital", "spectral"):
        tmp = hybrid.init_params(cfg, torch.Generator("cuda").manual_seed(seed + 1), device="cuda")
        steps = th.train_steps(cfg, tmp, epochs=3, impl=impl)
        times, _ = _timed_steps(steps, 11)
        med = float(np.median(times[1:]))
        prof = _profile_steady(lambda: next(steps))
        report[f"step_ms_{impl}"] = {"median": med * 1e3, "steps_s": times[1:], "profile": prof}
        print(f"train: {impl:8s} step median {med * 1e3:.3f} ms (min {min(times[1:]) * 1e3:.3f}, "
              f"max {max(times[1:]) * 1e3:.3f}, n=10)  {TRAIN_BATCH / med:.1f} clips/s")
        busy = ("not measured" if prof["busy_share"] is None
                else f"{prof['device_ms']:.3f} ms ({prof['busy_share']:.1%})")
        print(f"profile: train {impl} step wall {prof['wall_ms']:.3f} ms, device busy {busy}")
        for kn, ms in prof["top_kernels_ms"]:
            print(f"profile:   {ms:9.3f} ms  {kn}")
        del tmp, steps

    # the main path, counted: train on spectral, evaluate on every backend,
    # sweep the ablation
    conv_kernel.reset_launches()
    stmul_kernel.reset_launches()
    t0 = time.perf_counter()
    times, auxes = _timed_steps(th.train_steps(cfg, params, epochs=TRAIN_EPOCHS), 10**9)
    train_s = time.perf_counter() - t0
    losses = {i: float(a["loss"]) for i, a in enumerate(auxes) if i % 20 == 0}
    for i, loss in losses.items():
        print(f"train: step {i:3d} loss {loss:.4f} acc {float(auxes[i]['accuracy']):.3f}")
    med = float(np.median(times[1:]))
    last = losses[max(losses)]
    report |= {"steps": len(times), "train_s": train_s, "first_step_s": times[0],
               "step_ms_median": med * 1e3, "clips_per_s": TRAIN_BATCH / med,
               "clips_per_s_whole_run": len(times) * TRAIN_BATCH / train_s,
               "logged_losses": losses}
    print(f"train: {len(times)} steps in {train_s:.2f} s (first step {times[0]:.2f} s, with the "
          f"split's render and copy); step median {med * 1e3:.3f} ms, {TRAIN_BATCH / med:.1f} "
          f"clips/s ({len(times) * TRAIN_BATCH / train_s:.1f} over the whole run)")
    print(f"train: last logged loss (step {max(losses)}) {last:.4f} (bound {TRAIN_LOSS_MAX:g})")
    if len(times) != TRAIN_EPOCHS * (len(y_train) // TRAIN_BATCH):
        raise AssertionError(f"trained {len(times)} steps")
    if not last < TRAIN_LOSS_MAX:
        raise AssertionError(f"the last logged loss {last:.4f} is not below {TRAIN_LOSS_MAX}")

    acc = {}
    for split, impl in (("val", "spectral"), ("test", "spectral"), ("test", "digital"),
                        ("test", "sthc_physical")):
        acc[f"{split}_{impl}"], conf = th.evaluate(cfg, params, split, impl)
        report[f"confusion_{split}_{impl}"] = conf.tolist()
        print(f"train: {split:4s} accuracy {impl:13s} {acc[f'{split}_{impl}']:.4f}"
              f"  confusion {conf.tolist()}")
    report["accuracy"] = acc
    x_test, _ = kth.make_split("test")
    with torch.no_grad():
        logits = {impl: torch.cat([hybrid.forward(params, x_test[i : i + CLASSIFY_BATCH], cfg, impl)
                                   for i in range(0, len(x_test), CLASSIFY_BATCH)])
                  for impl in ("digital", "spectral")}
    report["digital_vs_spectral_ties"] = _same_classes(
        "trained digital vs spectral", logits["digital"].argmax(-1).cpu().numpy(),
        logits["spectral"].argmax(-1).cpu().numpy(), logits["digital"])
    for key in ("test_spectral", "test_digital"):
        if not acc[key] >= TRAIN_ACC_MIN:
            raise AssertionError(f"{key} accuracy {acc[key]:.4f} is below {TRAIN_ACC_MIN}")

    rows = th.ablation_rows(cfg, params, log=lambda line: print("train: ablation" + line))
    bench = _bench_ablation()
    ablation = {}
    cumulative = {f"ablation_{name}" for name, _ in fidelity.ablation_stacks()}
    for row in rows:
        name, _, derived = row.split(",", 2)
        fields = dict(f.split("=") for f in derived.split(";")) if "=" in derived else {}
        ablation[name] = fields or derived
        if "acc" in fields:
            ref = bench.get(name)
            print(f"train: {name:30s} acc {fields['acc']}  (BENCH_ablation.json "
                  f"{'n/a' if ref is None else f'{ref:.4f}'}; paper hybrid test 0.5972)  "
                  + "  ".join(f"{k}={v}" for k, v in fields.items() if k != "acc"))
            if name in cumulative and not float(fields["acc"]) >= ABLATION_ACC_MIN:
                raise AssertionError(f"{name} accuracy {fields['acc']} is below {ABLATION_ACC_MIN}")
        else:
            print(f"train: {name} {derived}")
    report["ablation"] = ablation
    if not cumulative <= set(ablation):
        raise AssertionError(f"ablation rows miss {sorted(cumulative - set(ablation))}")
    torch.cuda.synchronize()
    b4_n = conv_kernel.conv3d_cuda.launches
    b1_n = stmul_kernel.spectral_mac_cuda.launches
    report["launches"] = {"conv3d": b4_n, "spectral_mac": b1_n}
    print(f"train: launches in the phase's main path: conv3d {b4_n}, spectral_mac {b1_n}")
    if b4_n <= 0 or b1_n <= 0:
        raise AssertionError(f"a kernel of the path did not launch: B4 {b4_n}, B1 {b1_n}")

    w = params.conv_w.detach()
    rows = [_conv_row(f"[{TRAIN_BATCH}x60x80x16]", batch["video"], w, b4_n, CONV_RTOL,
                      want_route="wgmma")]
    report["seconds"] = time.perf_counter() - t_phase
    print(f"train: phase {report['seconds']:.1f} s")
    return report, rows


MESH_SHAPES = ((1, 1), (1, 2), (2, 1), (2, 2), (1, 4))  # (1, 1) on the default devices
MESH_CHUNK_FRAMES = 4096  # the chunked row's cursor streams (max_buffer_windows 8)
MESH_TOPK = 3


def _mesh_server(tenants, shape, **cfg):
    """The paper-geometry server, fused readout at K = 3; on a mesh of
    ``shape`` when given: (1, 1) on the default devices (the card), the
    others logical meshes repeating cuda:0."""
    if shape is not None:
        cfg["mesh_shape"] = shape
        if shape != (1, 1):
            cfg["mesh_devices"] = ("cuda:0",) * (shape[0] * shape[1])
    return _server(tenants, readout_topk=MESH_TOPK, **cfg)


def _same_detections(a: list, b: list) -> bool:
    """Two batches of answers bitwise equal: scores, peak frames, the K =
    3 lists and the stitched volumes, whichever the answers hold."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if not (isinstance(x, dict) and isinstance(y, dict) and x.keys() == y.keys()):
            return False
        for key in ("scores", "topk_scores"):
            if key in x and not np.array_equal(x[key].view(np.int32), y[key].view(np.int32)):
                return False
        for key in ("peak_frame", "topk_frames"):
            if key in x and not np.array_equal(x[key], y[key]):
                return False
        if "volume" in x and not _bits_equal(x["volume"], y["volume"]):
            return False
    return True


@contextlib.contextmanager
def _spying(obj, name: str, record):
    """Within the block, a call to ``obj.<name>`` hands its arguments to
    ``record`` and then runs the original, which still counts its own
    launches: a window on what the main path passes, for measurement."""
    own = name in vars(obj)
    fn = getattr(obj, name)

    def spy(*args, **kw):
        record(*args, **kw)
        return fn(*args, **kw)

    setattr(obj, name, spy)
    try:
        yield
    finally:
        if own:
            setattr(obj, name, fn)
        else:
            delattr(obj, name)


def _mesh_watch(srv):
    """Record what the mesh server's next batch gives the mesh executor
    and B2: per pool-group dispatch its tiles and physical rows, and per
    distinct (rows, tile) B2 launch its inputs (the spectra cloned).
    Returns (context manager, dispatches, launches)."""
    from repro_torch.kernels.stmul import ops as stmul_ops

    eng = srv.sthc.engine
    dispatches, launches = [], {}

    def dispatch(mesh, tiles, x, *rest):
        dispatches.append((tiles, int(x.shape[0])))

    def b2(xhat, pool_re, pool_im, o_start, n_out):
        B, C = int(xhat.shape[0]), int(xhat.shape[1])
        key = (B, pool_re.data_ptr(), int(n_out))
        if key not in launches:
            rows = int(pool_re.shape[0])
            launches[key] = {
                "x": xhat.reshape(B, C, -1).contiguous().clone(),
                "re": pool_re.reshape(rows, C, -1),
                "im": pool_im.reshape(rows, C, -1),
                "offs": [int(o) for o in o_start],
                "n_out": int(n_out),
                "zero_tile": not bool(torch.any(pool_re)) and not bool(torch.any(pool_im)),
            }

    stack = contextlib.ExitStack()
    stack.enter_context(_spying(eng, "_mesh_dispatch", dispatch))
    stack.enter_context(_spying(stmul_ops, "spectral_mac_grouped", b2))
    return stack, dispatches, launches


def _mesh_work(srv, dispatches, d: int) -> tuple[float, float, list]:
    """benchmarks/mesh.py's ``per_device_work_x`` and ``arena_x`` for the
    batch the server dispatched: per pool group (read from the engine's
    memoized tiles) its physical rows b, its unsharded arena rows (the
    members packed by ``_build_pool(members, 1)``, as the reference
    reckons) and its tile rows; per device a group holds ceil(b / data)
    rows against one tile."""
    from repro_torch.core.engine import _build_pool

    eng = srv.sthc.engine
    with eng._pools_lock:
        pool_of = {id(tiles): pool for pool, tiles in eng._mesh_arenas.values()}
    groups = []
    for tiles, b in dispatches:
        pool = pool_of[id(tiles)]
        single = int(_build_pool(list(pool.members), 1).re.shape[0])
        groups.append({"rows": b, "arena_rows": single, "tile_rows": pool.shard_rows,
                       "tiles": pool.shards})
    work = sum(g["rows"] * g["arena_rows"] for g in groups)
    per_dev = sum(-(-g["rows"] // d) * g["tile_rows"] for g in groups)
    arena = sum(g["arena_rows"] for g in groups)
    tile = sum(g["tile_rows"] for g in groups)
    return work / per_dev, arena / tile, groups


def _arena_bytes(server, mesh: bool) -> int:
    """Arena bytes one device holds: the pools of the server's engine, or
    the tiles its mesh executor placed on device (0, 0)."""
    eng = server.sthc.engine
    with eng._pools_lock:
        if not mesh:
            return sum(p.nbytes for key, p in eng._pools.items() if key[1] == 1)
        return sum(t[0][0][0].nbytes + t[0][0][1].nbytes for _, t in eng._mesh_arenas.values())


def _b2_shard_row(kernel, ref, tag: str, cap: dict, launches: int) -> dict:
    """B2 on the inputs a mesh shard launched it with in the phase's
    batch (``_mesh_watch``): its rows against the shard's tile read whole
    (all-zero offsets), bitwise against its plain version; the library
    call is one einsum of the tile."""
    from repro_torch.core import spectral_conv

    x, pre, pim, offs, n = cap["x"], cap["re"], cap["im"], cap["offs"], cap["n_out"]
    if any(offs):
        raise AssertionError(f"B2 at the {tag}: offsets {offs} on a mesh shard")
    B, C, F = x.shape
    tile = torch.complex(pre.float(), pim.float())
    with spectral_conv.full_precision():
        out = kernel.spectral_mac_grouped_cuda(x, pre, pim, offs, n)
        exp = ref.spectral_mac_grouped_ref(x, pre, pim, offs, n)
        if not _bits_equal(torch.view_as_real(out), torch.view_as_real(exp)):
            raise AssertionError(f"B2 at the {tag} differs from its plain version")
        err = float(torch.max(torch.abs(out - exp)))
        ms = _time_ms(lambda: kernel.spectral_mac_grouped_cuda(x, pre, pim, offs, n), 20)
        plain_ms = _time_ms(lambda: ref.spectral_mac_grouped_ref(x, pre, pim, offs, n), 3)
        lib_ms = _time_ms(lambda: torch.einsum("bcf,ocf->bof", x, tile), 20)
    bound, by = _kernel_bound("spectral_mac_grouped", B=int(B), C=int(C), F=int(F), o_start=tuple(offs),
                              n_out=int(n), itemsize=pre.element_size())
    print(f"mesh: B2 at the {tag} ({B} rows x {n}-row tile, zero offsets{', tile all zero' if cap['zero_tile'] else ''}) "
          f"bitwise its plain version, {ms:.4f} ms (bound {bound:.4f} {by}, plain {plain_ms:.3f}, einsum "
          f"{lib_ms:.4f})")
    return {
        "name": f"spectral_mac_grouped[f32,{tag}]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/stmul/csrc/stmul.cu",
        "replaces": "src/repro/kernels/stmul/kernel.py:248",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": lib_ms,
        "shape": {"B": int(B), "n_out": int(n), "C": int(C), "F": int(F), "zero_tile": cap["zero_tile"]},
    }


# the B2 rows at mesh shards: (shape, tag, whether the tile is all zero);
# each takes that shape's widest launch of that kind in the batch
MESH_B2_ROWS = (((1, 2), "(1, 2) shard", False), ((1, 4), "(1, 4) zero tile", True))


def phase_mesh(kernel, ref, seed: int, card: str) -> tuple[dict, list[dict]]:
    """Mesh-sharded video search on the card: the serving batch on one
    device and on (1, 1), (1, 2), (2, 1), (2, 2) and (1, 4) meshes,
    benchmarks/mesh.py's five exactness rows bitwise, the mesh metric,
    launch counts per call against the shard count, latency, memory and
    a profiled call per shape."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    tenants = _tenants(rng)
    reqs = _requests(rng)
    shared = [(t, reqs[0][1]) for t in "ABCD"]  # every tenant on one clip
    gen = np.random.default_rng([seed, 4])
    hw = tuple(reqs[0][1].shape[2:4])
    long = [gen.random((1, 1) + hw + (MESH_CHUNK_FRAMES,), dtype=np.float32) for _ in range(2)]
    chunked = [("A", long[0]), ("B", long[0]), ("C", long[1]), ("D", long[1])]
    frames = sum(c.shape[0] * c.shape[-1] for _, c in reqs)
    report, want, b2_caps = {"shapes": {}}, {}, []
    kernel.reset_launches()
    for shape in (None,) + MESH_SHAPES:
        tag = "single" if shape is None else f"{shape}"
        srv = _mesh_server(tenants, shape)
        before = _launch_counts(kernel)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        out, lat = _run(srv, reqs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        after = _launch_counts(kernel)
        per_call = {k: (after[k] - before[k]) / (SERVE_REPS + 1) for k in after}
        prof = _profile(lambda srv=srv: srv.search_batch(reqs))
        by = prof["by_name_ms"]
        dev_ms = {
            "B2": sum(v for k, v in by.items() if "mac_grouped" in k),
            "B3": sum(v for k, v in by.items() if "topk" in k),
            "cuFFT": sum(v for k, v in by.items() if "fft" in k.lower()),
        }
        rows = {
            "volume": srv.search_batch(reqs, return_volume=True),
            "fused_topk": out,
            "dedup": srv.search_batch(shared),
            "dedup_off": srv.search_batch(shared, dedup=False),
        }
        chunk_srv = _mesh_server(tenants, shape, max_buffer_windows=8)
        rows["chunked"] = chunk_srv.search_batch(chunked)
        bf16 = _mesh_server(tenants, shape, grating_dtype="bfloat16")
        rows["bf16"] = bf16.search_batch(reqs)
        metric = srv.metrics()["mesh"]
        arena = _arena_bytes(srv, shape is not None)
        if shape is not None:  # the batch once more, its dispatches and B2 inputs recorded
            watch, dispatches, b2_in = _mesh_watch(srv)
            with watch:
                srv.search_batch(reqs)
            work = _mesh_work(srv, dispatches, shape[0])
            for at, b2_tag, zero in MESH_B2_ROWS:
                if at != shape:
                    continue
                caps = [c for c in b2_in.values() if c["zero_tile"] == zero]
                if not caps:
                    raise AssertionError(f"mesh {shape}: no B2 launch on a {b2_tag}")
                b2_caps.append((b2_tag, max(caps, key=lambda c: c["x"].shape[0] * c["n_out"])))
            del b2_in
        del chunk_srv, bf16
        entry = {
            "median_ms": float(np.median(lat)) * 1e3, "latency_s": lat, "peak_device_bytes": peak,
            "resident_before_bytes": resident,
            "launches_per_call": per_call, "device_ms": dev_ms, "profile_wall_ms": prof["wall_ms"],
            "arena_bytes_per_device": arena, "mesh_metric": metric,
        }
        if shape is None:
            want = rows
            single_calls = per_call
            if metric is not None:
                raise AssertionError(f"mesh: the single-device server reports mesh {metric}")
        else:
            d, m = shape
            exact = {
                "volume": _same_detections(rows["volume"], want["volume"]),
                "fused_topk": _same_detections(rows["fused_topk"], want["fused_topk"]),
                "dedup": _same_detections(rows["dedup"], want["dedup"])
                and _same_detections(rows["dedup"], rows["dedup_off"]),
                "chunked": _same_detections(rows["chunked"], want["chunked"]),
                "bf16": _same_detections(rows["bf16"], want["bf16"]),
            }
            work_x, arena_x, groups = work
            entry |= {"exact": exact, "per_device_work_x": work_x, "arena_x": arena_x,
                      "groups": groups}
            if metric != {"shape": {"data": d, "model": m}, "devices": d * m}:
                raise AssertionError(f"mesh {shape}: metrics()['mesh'] is {metric}")
            if not all(exact.values()):
                raise AssertionError(f"mesh {shape}: not bitwise the single device: {exact}")
            if per_call["spectral_mac"] != 0:
                raise AssertionError(f"mesh {shape}: B1 launched on the pooled mesh path")
            for k in ("spectral_mac_grouped", "topk_readout"):
                if per_call[k] != d * m * single_calls[k] or single_calls[k] <= 0:
                    raise AssertionError(f"mesh {shape}: {k} {per_call[k]} launches a call, "
                                         f"predicted {d * m} x {single_calls[k]}")
        report["shapes"][tag] = entry
        extra = "" if shape is None else (
            f"; per_device_work_x {entry['per_device_work_x']:.3f}, arena_x {entry['arena_x']:.3f} "
            f"(groups {[(g['rows'], g['arena_rows'], g['tile_rows']) for g in entry['groups']]} as "
            f"(rows, arena rows, tile rows)); bitwise {entry['exact']}")
        print(
            f"mesh: {tag:8s} median {entry['median_ms']:8.2f} ms (n={SERVE_REPS}) {frames / np.median(lat):10.1f} "
            f"frames/s, peak {peak / 2**20:.1f} MiB ({(peak - resident) / 2**20:.1f} above the resident), per call B2 {per_call['spectral_mac_grouped']:.0f} / B3 "
            f"{per_call['topk_readout']:.0f} / B1 {per_call['spectral_mac']:.0f} launches, device ms B2 "
            f"{dev_ms['B2']:.3f} B3 {dev_ms['B3']:.3f} cuFFT {dev_ms['cuFFT']:.3f} (profiled call "
            f"{prof['wall_ms']:.2f} ms), arena {arena / 2**20:.1f} MiB per device, metric {metric}{extra} "
            f"[{card}]"
        )
        del srv, out, rows
    report["launches"] = _launch_counts(kernel)
    rows = [_b2_shard_row(kernel, ref, tag, cap, report["launches"]["spectral_mac_grouped"])
            for tag, cap in b2_caps]
    report["seconds"] = time.perf_counter() - t0
    print(f"mesh: phase {report['seconds']:.1f} s [{card}]")
    return report, rows


LM_TRAIN_STEPS = 8  # train_loop steps of each full-size model
LM_TRAIN_SHAPE = (4, 2048)  # (sequences, tokens) a step
LM_TRAIN_MODELS = ("qwen2-1.5b", "mamba2-370m")
# one arch of each LM family, for the kernel-route gradients on smoke configs
LM_TRAIN_FAMILIES = ("qwen2-1.5b", "mamba2-370m", "zamba2-2.7b", "arctic-480b",
                     "deepseek-v2-lite-16b", "whisper-tiny", "internvl2-2b")
LM_GRAD_RTOL = 1e-4  # kernel vs plain route gradients, relative L2 per parameter
# the restart check: mamba2-370m at full width, cut to 8 of its 48 layers
RESTART_LAYERS, RESTART_SHAPE, RESTART_STEPS, RESTART_SAVE_EVERY = 8, (2, 512), 12, 4
RESTART_FAIL_AT = (5, 9)
RESTART_RTOL = 1e-6  # only where an op on the path has no deterministic CUDA version


@contextlib.contextmanager
def _recording_train_steps(kernels: dict, record: list):
    """Within the block, every step function ``launch.train.make_step_fn``
    makes is timed on the host clock between two synchronisations and
    records its loss, grad norm and the launches of each of ``kernels``
    (name -> wrapper); the last step's model and optimizer state are kept
    in ``record[-1]`` for the checks after the loop."""
    from repro_torch.launch import train as train_lib

    orig = train_lib.make_step_fn

    def make(cfg, opt_cfg, tc):
        fn = orig(cfg, opt_cfg, tc)

        def step_fn(model, opt_state, err_state, batch, step):
            torch.cuda.synchronize()
            before = {n: k.launches for n, k in kernels.items()}
            t0 = time.perf_counter()
            out = fn(model, opt_state, err_state, batch, step)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            metrics = out[3]
            record.append({
                "step": step, "ms": ms, "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "launches": {n: k.launches - before[n] for n, k in kernels.items()},
                "model": out[0], "opt": out[1],
            })
            if len(record) > 1:  # keep only the last step's state alive
                record[-2].pop("model", None)
                record[-2].pop("opt", None)
            return out

        return step_fn

    train_lib.make_step_fn = make
    try:
        yield
    finally:
        train_lib.make_step_fn = orig


def _grad_check(tag, cfg, model, batch, card) -> dict:
    """One more forward and backward on ``batch``, outside the timed steps:
    every trainable parameter's gradient must exist, be finite and not be
    all zero."""
    from repro_torch.launch import train as train_lib

    _, grads = train_lib.loss_and_grads(cfg, model, batch)
    names = list(train_lib.trainable(model))
    missing = [n for n in names if n not in grads or grads[n] is None]
    bad = [n for n in names if n not in missing and not bool(torch.isfinite(grads[n]).all())]
    zero = [n for n in names if n not in missing and not bool((grads[n] != 0).any())]
    print(f"lm_train: {tag} gradients of {len(names)} parameters: {len(missing)} missing, "
          f"{len(bad)} not finite, {len(zero)} all zero [{card}]")
    if missing or bad or zero:
        raise AssertionError(f"{tag}: gradients missing {missing}, not finite {bad}, all zero {zero}")
    del grads
    return {"parameters": len(names)}


def _train_full(name, seed, card, kernels, ckpt) -> tuple[dict, list, dict]:
    """``train_loop`` on a full-size config for ``LM_TRAIN_STEPS`` steps at
    ``LM_TRAIN_SHAPE`` on the card (saves off in the timed steps, one final
    save into ``ckpt``, which the ``reshard`` phase restores); returns the
    report, the per-step records and the last step's model and a batch for
    the checks after it."""
    from repro_torch import configs
    from repro_torch.data import tokens as token_data
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model_api
    from repro_torch.optim import AdamWConfig

    cfg = configs.get_config(name)
    Bb, S = LM_TRAIN_SHAPE
    tc = train_lib.TrainConfig(steps=LM_TRAIN_STEPS, batch=Bb, seq=S,
                               save_every=LM_TRAIN_STEPS + 1, seed=seed)
    steps, logs = [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _recording_train_steps(kernels, steps):
        out = train_lib.train_loop(cfg, tc, ckpt, opt_cfg=AdamWConfig(lr=1e-3),
                                   log=logs.append, device="cuda")
    loop_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    totals = {n: k.launches for n, k in kernels.items()}
    last = steps[-1]
    model, opt = last.pop("model"), last.pop("opt")
    losses = [r["loss"] for r in steps]
    timed = [r["ms"] for r in steps[1:]]  # steps 2 .. 8: the first builds cuBLAS plans
    med = float(np.median(timed))
    tokens = Bb * S
    flops = model_api.model_flops_per_token(cfg, train=True) * tokens
    share = flops / (med * 1e-3) / BF16_FLOPS
    per_step = [r["launches"] for r in steps]
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    state = sum(t.numel() * t.element_size() for t in (*opt["m"].values(), *opt["v"].values()))
    rec = {
        "config": cfg.name, "params": cfg.num_params(), "steps": len(steps),
        "batch": [Bb, S], "step_ms": [r["ms"] for r in steps], "median_step_ms": med,
        "tokens_per_s": tokens / (med * 1e-3), "model_flops_per_step": flops,
        "model_flop_share": share, "max_memory_allocated": peak, "weight_bytes": weights,
        "adam_state_bytes": state, "losses": losses,
        "grad_norms": [r["grad_norm"] for r in steps], "launches_per_step": per_step,
        "launches": totals, "loop_s": loop_s, "final_save_and_setup_s": loop_s - sum(r["ms"] for r in steps) / 1e3,
        "log": logs,
    }
    print(f"lm_train: {cfg.name} ({cfg.num_params()} parameters, {cfg.n_layers} layers, "
          f"remat {cfg.remat_policy}) {Bb}x{S}, {len(steps)} steps: median step (2-{len(steps)}) "
          f"{med:.2f} ms (min {min(timed):.2f}, max {max(timed):.2f}; first {steps[0]['ms']:.2f}), "
          f"{rec['tokens_per_s']:.1f} tok/s, model-FLOP share {share:.2%} (6 x params x "
          f"{tokens} tokens = {flops / 1e12:.2f} TFLOP a step, of 989 TFLOP/s) [{card}]")
    print(f"lm_train: {cfg.name} peak memory {peak / 2**30:.2f} GiB (weights {weights / 2**30:.2f}, "
          f"AdamW m+v {state / 2**30:.2f}); loss step 0 {losses[0]:.4f} (ln V = "
          f"{np.log(cfg.vocab):.4f}), step {len(steps) - 1} {losses[-1]:.4f}; launches per step "
          + "; ".join(f"{n} {[p[n] for p in per_step]}" for n in kernels)
          + f"; loop {loop_s:.1f} s [{card}]")
    if len(steps) != LM_TRAIN_STEPS or not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"{cfg.name}: steps {len(steps)}, losses {losses}")
    if abs(losses[0] - np.log(cfg.vocab)) > 2.5:
        raise AssertionError(f"{cfg.name}: step-0 loss {losses[0]} far from ln V")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: the loss did not fall: {losses}")
    for n in kernels:
        counts = {p[n] for p in per_step}
        if len(counts) != 1 or 0 in counts:
            raise AssertionError(f"{cfg.name}: {n} launched {[p[n] for p in per_step]} times a step")
    ds = token_data.TokenStreamConfig(vocab=cfg.vocab, seq_len=S, seed=seed)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             token_data.batch_at_step(ds, LM_TRAIN_STEPS, Bb).items()}
    rec["grads"] = _grad_check(cfg.name, cfg, model, batch, card)
    return rec, (cfg, model, opt, batch)


# the parts of a train step whose device time a profile attributes, each
# the sum of these profiler rows (an op's row holds the kernels it and its
# children launched): the autograd nodes of the two kernels' Functions,
# whose backward is the plain version under autograd, and the
# cross-entropy's log_softmax; the AdamW update is the kernels inside its
# record_function range
STEP_PARTS = {
    "attention backward (plain blockwise)": ("autograd::engine::evaluate_function: _FlashAttentionBackward",),
    "SSD backward (plain chunked)": ("autograd::engine::evaluate_function: _SSDBackward",),
    "cross-entropy log_softmax (forward, backward)": ("aten::_log_softmax", "aten::_log_softmax_backward_data"),
}


def _device_ms_under(prof, names) -> dict[str, float] | None:
    """Device ms of the kernels launched inside each host op of
    ``names``, its children's included: the op's ``device_time_total`` in
    ``prof.key_averages()``, summed over its calls, read from the raw
    events (a kernel belongs to the host op its launch is linked to, and
    that op to every op of the same thread whose span holds its start).
    None where the profiler's raw results do not link kernels to ops."""
    import bisect

    from torch.autograd import DeviceType

    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is None:
        return None
    events = raw.events()
    if events and not hasattr(events[0], "linked_correlation_id"):
        return None
    names = set(names)
    launched_at, spans = {}, {n: {} for n in names}
    for e in events:
        if e.device_type() == DeviceType.CPU:
            launched_at[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
            if e.name() in names:
                spans[e.name()].setdefault(e.start_thread_id(), []).append((e.start_ns(), e.end_ns()))
    for by_thread in spans.values():
        for ranges in by_thread.values():
            ranges.sort()
    out = dict.fromkeys(names, 0.0)
    for e in events:
        if e.device_type() != DeviceType.CUDA or getattr(e, "is_user_annotation", lambda: False)():
            continue
        at = launched_at.get(e.linked_correlation_id())
        if at is None:
            continue
        thread, t = at
        for n in names:
            ranges = spans[n].get(thread)
            if not ranges:
                continue
            i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
            # ranges of one name may nest (a recursive op): count a kernel once
            while i >= 0:
                if ranges[i][0] <= t <= ranges[i][1]:
                    out[n] += e.duration_ns() / 1e6
                    break
                i -= 1
    return out


def _kernels_in_range(prof, label: str):
    """Device ms of the kernels that start inside the device-side range
    of ``record_function(label)``; None where the trace has no such range."""
    events = _device_events(prof)
    spans = [(start, start + dur) for name, start, dur, _ in events if name == label]
    if not spans:
        return None
    lo, hi = spans[0]
    return sum(
        dur for name, start, dur, annotation in events
        if name != label and not annotation and lo <= start <= hi
    ) / 1e6


def _profiled_step(tag, cfg, model, opt, batch, card) -> dict:
    """One more train step under torch.profiler, with the AdamW update's
    host time between two synchronisations: device ms by kind, busy share,
    the device ms of ``STEP_PARTS``, the optimizer's share of the step."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.launch import train as train_lib
    from repro_torch.optim import AdamWConfig

    tc = train_lib.TrainConfig(steps=LM_TRAIN_STEPS, batch=batch["tokens"].shape[0],
                               seq=batch["tokens"].shape[1])
    step_fn = train_lib.make_step_fn(cfg, AdamWConfig(lr=1e-3), tc)
    opt_ms = []
    orig = train_lib.adamw_lib.adamw_update

    def timed_update(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function("adamw_update"):
            out = orig(*a, **kw)
            torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    train_lib.adamw_lib.adamw_update = timed_update
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            t0 = time.perf_counter()
            step_fn(model, opt, {}, batch, LM_TRAIN_STEPS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        train_lib.adamw_lib.adamw_update = orig
    prof = _device_time(tp, wall_ms, 1)
    kinds = prof["by_kind_ms"] = _by_kind(prof["by_name_ms"])
    rows = _device_ms_under(tp, {k for keys in STEP_PARTS.values() for k in keys})
    if rows is None:
        rows = {e.key: e.device_time_total / 1e3 for e in tp.key_averages()}
    parts = {part: sum(rows.get(k, 0.0) for k in keys) for part, keys in STEP_PARTS.items()}
    parts["AdamW update"] = _kernels_in_range(tp, "adamw_update")
    prof["parts_device_ms"] = parts
    prof["optimizer_ms"] = opt_ms[0]
    prof["optimizer_share"] = opt_ms[0] / prof["wall_ms"]
    busy = ("not measured" if prof["busy_share"] is None
            else f"{prof['device_ms']:.2f} ms ({prof['busy_share']:.1%})")
    print(f"profile: lm_train {tag} step wall {prof['wall_ms']:.2f} ms, device busy {busy}; AdamW "
          f"update {opt_ms[0]:.2f} ms ({prof['optimizer_share']:.1%} of the step, host clock) [{card}]")
    for kn, ms in prof["top_kernels_ms"]:
        print(f"profile:   {ms:9.3f} ms  {kn}")
    print(f"profile: lm_train {tag} by kind: "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in kinds.items()) + f" [{card}]")
    print(f"profile: lm_train {tag} device ms of: "
          + ", ".join(f"{k} " + ("not measured" if ms is None else f"{ms:.3f}") for k, ms in parts.items())
          + f" [{card}]")
    return prof


def _route_grads(tag, cfg, batch, gen, card) -> dict:
    """The gradients of one float32 loss on the kernel routes (B6 for
    attention, B5 for the SSD) and on the plain ones (``blockwise``,
    ``chunked``) from the same weights and batch: every parameter within
    ``LM_GRAD_RTOL`` (relative L2)."""
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model_api

    mod = model_api.get_model(cfg)
    m_k = mod.init_params(cfg, gen, device="cuda")
    plain = {"attn_impl": "blockwise"}
    if hasattr(cfg, "ssd_impl"):
        plain["ssd_impl"] = "chunked"
    m_p = type(m_k)(dataclasses.replace(cfg, **plain), "cuda")
    m_p.load_state_dict(m_k.state_dict())
    for m in (m_k, m_p):
        m.requires_grad_(True)
    loss_k, g_k = train_lib.loss_and_grads(cfg, m_k, batch)
    loss_p, g_p = train_lib.loss_and_grads(m_p.cfg, m_p, batch)
    rel = {}
    for n in g_p:
        den = float(torch.linalg.vector_norm(g_p[n].float()))
        num = float(torch.linalg.vector_norm(g_k[n].float() - g_p[n].float()))
        rel[n] = num / den if den > 0 else num
    worst = max(rel, key=rel.get)
    res = {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
           "worst_param": worst, "worst_rel_l2": rel[worst], "parameters": len(rel)}
    print(f"lm_train: {tag} f32 gradients, kernel vs plain routes: loss {float(loss_k):.6f} vs "
          f"{float(loss_p):.6f}, worst of {len(rel)} parameters {worst} rel L2 {rel[worst]:.3g} "
          f"(<= {LM_GRAD_RTOL:g}) [{card}]")
    if not (rel[worst] <= LM_GRAD_RTOL and np.isfinite(float(loss_k))):
        raise AssertionError(f"{tag}: kernel-route gradients disagree with the plain route's: {res}")
    del m_k, m_p, g_k, g_p
    torch.cuda.empty_cache()
    return res


def _smoke_batch(cfg, gen, B=2, S=48) -> dict:
    batch = {
        "tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda"),
        "labels": torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda"),
    }
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, cfg.n_frames, cfg.d_model), generator=gen, device="cuda")
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((B, cfg.n_patches, cfg.d_model), generator=gen, device="cuda")
    return batch


def _kernels_repeat(train_args, card) -> dict:
    """B5 and B6 at the training shapes, each launched twice on the same
    inputs: the two outputs must be equal bit for bit (the recomputation
    of full remat relaunches them)."""
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel

    out = {}
    q, k, v = train_args["b6"]
    a, b = flash_kernel.flash_fwd_cuda(q, k, v, True), flash_kernel.flash_fwd_cuda(q, k, v, True)
    out["b6_repeat_bitwise"] = bool(torch.equal(a.view(torch.int16), b.view(torch.int16)))
    args, chunk = train_args["b5"]
    (y1, s1), (y2, s2) = ssd_kernel.ssd_chunked_cuda(*args, chunk), ssd_kernel.ssd_chunked_cuda(*args, chunk)
    out["b5_repeat_bitwise"] = _bits_equal(y1, y2) and _bits_equal(s1, s2)
    print(f"lm_train: repeated launches on the same inputs bitwise equal: B6 {out['b6_repeat_bitwise']}, "
          f"B5 {out['b5_repeat_bitwise']} [{card}]")
    if not (out["b6_repeat_bitwise"] and out["b5_repeat_bitwise"]):
        raise AssertionError(f"a kernel answered differently on the same inputs: {out}")
    out["ssd_op_grads"] = _ssd_op_grads(args, chunk, card)
    return out


def _ssd_op_grads(args, chunk, card) -> dict:
    """``ssd_ops.ssd(impl='kernel')`` on CUDA inputs that require grad: its
    outputs carry a graph, and its gradients for x, dt, A, B and C are
    those of autograd through the plain version on the same inputs
    (relative L2 <= ``SSD_RTOL``)."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    gen = torch.Generator("cuda").manual_seed(1)
    L = args[0].shape[1]

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in args]
        y, S = fn(*leaves)
        gy = torch.randn(y.shape, generator=gen.manual_seed(2), device="cuda")
        gS = torch.randn(S.shape, generator=gen.manual_seed(3), device="cuda")
        has_graph = y.grad_fn is not None and S.grad_fn is not None
        return has_graph, torch.autograd.grad((y * gy).sum() + (S * gS).sum(), leaves)

    graph_k, g_k = grads(lambda x, dt, A, B, C: ssd_ops.ssd(x, dt, A, B, C, chunk=chunk, impl="kernel"))
    _, g_p = grads(lambda x, dt, A, B, C: ssd_ref.ssd_chunked_ref(x, dt, A, B, C, chunk=chunk))
    rel = {n: _rel_l2(a, b) for n, a, b in zip(("x", "dt", "A", "B", "C"), g_k, g_p)}
    bitwise = all(_bits_equal(a, b) for a, b in zip(g_k, g_p))
    print(f"lm_train: ssd op (kernel route) on CUDA inputs that require grad {tuple(args[0].shape)}: "
          f"grad_fn {graph_k}; gradients vs autograd of the plain version: "
          + ", ".join(f"{n} {r:.3g}" for n, r in rel.items())
          + f" (<= {SSD_RTOL:g}), bitwise {bitwise} [{card}]")
    if not (graph_k and max(rel.values()) <= SSD_RTOL):
        raise AssertionError(f"the SSD op's kernel route has no graph or other gradients: {rel}")
    return {"grad_fn": graph_k, "rel_l2": rel, "bitwise": bitwise, "L": L}


def _restart_check(seed, card) -> dict:
    """The restart contract on the card: mamba2-370m at full width with
    ``RESTART_LAYERS`` layers, ``RESTART_STEPS`` steps of
    ``RESTART_SHAPE``, saving every ``RESTART_SAVE_EVERY``, once straight
    through and once killed at ``RESTART_FAIL_AT`` under
    ``run_with_restarts``; synchronous saves, deterministic algorithms.
    The final parameters must be equal bit for bit."""
    import tempfile

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.fault import FailureInjector, run_with_restarts
    from repro_torch.launch import train as train_lib
    from repro_torch.optim import AdamWConfig

    cfg = configs.get_config("mamba2-370m", n_layers=RESTART_LAYERS)
    Bb, S = RESTART_SHAPE
    tc = train_lib.TrainConfig(steps=RESTART_STEPS, batch=Bb, seq=S,
                               save_every=RESTART_SAVE_EVERY, async_ckpt=False, seed=seed)
    io = {"save": [], "restore": []}

    def timing(kind, fn):
        def wrapped(self, *a, **kw):
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            if kind == "save" or out is not None:
                io[kind].append(time.perf_counter() - t0)
            return out
        return wrapped

    def run(ckpt, failure=None):
        return run_with_restarts(lambda: train_lib.train_loop(
            cfg, tc, ckpt, opt_cfg=AdamWConfig(lr=1e-3), failure=failure,
            log=lambda *_: None, device="cuda"))

    saved = (CheckpointManager.save, CheckpointManager.restore_latest)
    CheckpointManager.save = timing("save", saved[0])
    CheckpointManager.restore_latest = timing("restore", saved[1])
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    exception = None
    root = tempfile.mkdtemp(prefix="lm_restart_")
    try:
        torch.use_deterministic_algorithms(True)
        try:
            clean = run(os.path.join(root, "clean"))
            faulty = run(os.path.join(root, "faulty"), FailureInjector(fail_at_steps=RESTART_FAIL_AT))
        except RuntimeError as e:
            if "deterministic" not in str(e):
                raise
            exception = str(e).splitlines()[0]
            print(f"lm_train: restart check: an op has no deterministic CUDA version: {exception}; "
                  f"the two runs are held within {RESTART_RTOL:g} instead [{card}]")
            torch.use_deterministic_algorithms(False)
            shutil.rmtree(root, ignore_errors=True)
            io = {"save": [], "restore": []}
            clean = run(os.path.join(root, "clean"))
            faulty = run(os.path.join(root, "faulty"), FailureInjector(fail_at_steps=RESTART_FAIL_AT))
    finally:
        torch.use_deterministic_algorithms(False)
        CheckpointManager.save, CheckpointManager.restore_latest = saved
        shutil.rmtree(root, ignore_errors=True)
    names = list(clean["params"])
    if exception is None:
        diff = [n for n in names if not torch.equal(clean["params"][n], faulty["params"][n])]
        worst = 0.0
    else:
        rel = {n: _rel_l2(faulty["params"][n].float(), clean["params"][n].float()) for n in names}
        diff = [n for n, r in rel.items() if not r <= RESTART_RTOL]
        worst = max(rel.values())
    res = {"config": cfg.name, "layers": cfg.n_layers, "batch": [Bb, S], "steps": RESTART_STEPS,
           "fail_at": list(RESTART_FAIL_AT), "deterministic_exception": exception,
           "params_differing": diff, "worst_rel_l2": worst, "loss": clean["loss"],
           "save_s": io["save"], "restore_s": io["restore"]}
    print(f"lm_train: restart {cfg.name} {cfg.n_layers} of 48 layers {Bb}x{S}, {RESTART_STEPS} steps, "
          f"killed at {RESTART_FAIL_AT}: final parameters "
          + ("bitwise equal" if exception is None and not diff else f"{len(diff)} of {len(names)} differ")
          + f" ({len(names)} tensors; deterministic algorithms "
          + ("on" if exception is None else "off: " + exception) + "); "
          f"{len(io['save'])} saves, median {np.median(io['save']):.3f} s; "
          f"{len(io['restore'])} restores, median {np.median(io['restore']):.3f} s [{card}]")
    if diff or clean["steps_done"] != faulty["steps_done"] or len(io["restore"]) != len(RESTART_FAIL_AT):
        raise AssertionError(f"the restarted run differs from the uninterrupted one: {res}")
    return res


# the mesh dry run's cells: (arch, shape, --mesh)
DRYRUN_MESH_CELLS = (("qwen2-1.5b", "train_4k", "single"), ("mamba2-370m", "train_4k", "single"),
                     ("qwen2-1.5b", "prefill_32k", "multi"))
DRYRUN_MESH_TIMEOUT_S = 300
ROOFLINE_REPS = 5  # timed steps of each counted step, after one warm-up
# the three steps the roofline phase counts: (tag, arch, mode) at LM_TRAIN_SHAPE
ROOFLINE_STEPS = (("qwen2-1.5b train", "qwen2-1.5b", "train"), ("mamba2-370m train", "mamba2-370m", "train"),
                  ("qwen2-1.5b prefill", "qwen2-1.5b", "prefill"))


def _roofline_args(cfg, mode, seed, device):
    """One step of ``mode`` at ``LM_TRAIN_SHAPE`` and its arguments on
    ``device``: the ``lm_train`` recipe's step (``make_step_fn``, AdamW with
    float32 moments) on its token stream, or a prefill into a cache of the
    prompt's length.  On ``meta`` the model is ``specs.abstract_model``'s
    and the batch empty tensors of the real batch's shapes and dtypes."""
    from repro_torch.data import tokens as token_data
    from repro_torch.launch import specs
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model_api
    from repro_torch.optim import AdamWConfig, adamw_init

    Bb, S = LM_TRAIN_SHAPE
    if device == "meta":
        model = specs.abstract_model(cfg)
    else:
        model = model_api.get_model(cfg).init_params(cfg, torch.Generator(device).manual_seed(seed), device=device)
    ds = token_data.TokenStreamConfig(vocab=cfg.vocab, seq_len=S, seed=seed)
    batch = {k: torch.from_numpy(v).to(device) for k, v in token_data.batch_at_step(ds, 0, Bb).items()}
    if mode == "prefill":
        return (lambda m, b: m.prefill(b["tokens"], max_len=S)), (model, batch)
    model.requires_grad_(True)
    opt_cfg = AdamWConfig(lr=1e-3)
    tc = train_lib.TrainConfig(steps=LM_TRAIN_STEPS, batch=Bb, seq=S, seed=seed)
    opt = adamw_init(opt_cfg, train_lib.trainable(model))
    return train_lib.make_step_fn(cfg, opt_cfg, tc), (model, opt, {}, batch, 0)


def _count(step, args, mode):
    grad = torch.enable_grad() if mode == "train" else torch.no_grad()
    with grad, op_analysis.OpCounter() as counter:
        step(*args)
    return counter.analysis


def _roofline_step(tag, arch, mode, seed, card) -> dict:
    """Count one step on ``meta`` and around one real step on the card,
    gated equal in FLOPs, bytes and per op name; then time the step with
    no counter (median of ``ROOFLINE_REPS`` after a warm-up) beside the
    roofline of the count."""
    from repro_torch import configs
    from repro_torch.models import model_api

    cfg = configs.get_config(arch)
    t0 = time.perf_counter()
    meta = _count(*_roofline_args(cfg, mode, seed, "meta"), mode)
    meta_s = time.perf_counter() - t0
    step, args = _roofline_args(cfg, mode, seed, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    real = _count(step, args, mode)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    keys = ("flops", "hbm_bytes", "op_flops", "op_bytes", "op_counts", "flops_by_class")
    differ = [k for k in keys if getattr(meta, k) != getattr(real, k)]
    if differ:
        ops = sorted(set(meta.op_bytes) | set(real.op_bytes))
        diff = {o: (meta.op_counts.get(o), real.op_counts.get(o), meta.op_bytes.get(o), real.op_bytes.get(o))
                for o in ops if meta.op_bytes.get(o) != real.op_bytes.get(o) or meta.op_counts.get(o) != real.op_counts.get(o)}
        raise AssertionError(f"roofline: {tag} counts differ on meta and the card in {differ}: {diff}")

    grad = torch.enable_grad() if mode == "train" else torch.no_grad()
    with grad:
        step(*args)  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(ROOFLINE_REPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
    step_peak = torch.cuda.max_memory_allocated() - base
    med = float(np.median(times))
    Bb, S = LM_TRAIN_SHAPE
    model_flops = model_api.model_flops_per_token(cfg, train=(mode == "train")) * Bb * S
    rl = roofline.analyze(real, 1, model_flops)
    bound_ms = max(rl.compute_s, rl.memory_s, rl.collective_s) * 1e3
    buckets = {k: {"gflop": real.op_flops[k] / 1e9, "gb": real.op_bytes[k] / 1e9,
                   "ms_at_hbm": real.op_bytes[k] / roofline.HBM_BW * 1e3}
               for k in real.op_bytes if k.endswith("(plain)") or k in ("flash_fwd", "ssd")}
    top = sorted(real.op_bytes.items(), key=lambda kv: -kv[1])[:6]
    rec = {
        "arch": arch, "mode": mode, "batch": [Bb, S], "median_ms": med, "ms": times,
        "bound_ms": bound_ms, "bottleneck": rl.bottleneck, "compute_ms": rl.compute_s * 1e3,
        "memory_ms": rl.memory_s * 1e3, "share_of_bound": bound_ms / med, "roofline": rl.to_json(),
        "model_flop_share": model_flops / (med * 1e-3) / roofline.PEAK_FLOPS_BF16,
        "temp_bytes_counted": real.peak_live_bytes, "temp_bytes_meta": meta.peak_live_bytes,
        "step_peak_bytes": step_peak, "temp_over_peak": real.peak_live_bytes / step_peak,
        "ops": sum(real.op_counts.values()), "count_s_meta": meta_s, "count_s_card": card_s,
        "buckets": buckets, "top_bytes": dict(top),
    }
    print(f"roofline: {tag} {Bb}x{S}: meta and card counts equal ({rec['ops']} ops, {rl.flops / 1e12:.3f} "
          f"TFLOP, {rl.hbm_bytes / 1e9:.2f} GB; counted in {meta_s:.1f} s on meta, {card_s:.1f} s on the "
          f"card) [{card}]")
    print(f"roofline: {tag} measured {med:.2f} ms (median of {ROOFLINE_REPS}), bound {bound_ms:.2f} ms "
          f"({rl.bottleneck}; compute {rl.compute_s * 1e3:.2f}, memory {rl.memory_s * 1e3:.2f}), bound / "
          f"measured {rec['share_of_bound']:.2%}; useful FLOPs ratio {rl.useful_flops_ratio:.3f}, "
          f"model-FLOP share {rec['model_flop_share']:.2%}; FLOPs by class "
          + ", ".join(f"{c} {f / 1e12:.3f} T" for c, f in sorted(rl.flops_by_class.items())) + f" [{card}]")
    print(f"roofline: {tag} temp {real.peak_live_bytes / 2**30:.2f} GiB counted (meta "
          f"{meta.peak_live_bytes / 2**30:.2f}) vs max_memory_allocated - arguments {step_peak / 2**30:.2f} "
          f"GiB: ratio {rec['temp_over_peak']:.3f}; " + "; ".join(
              f"{k} {v['gflop']:.1f} GFLOP {v['gb']:.2f} GB ({v['ms_at_hbm']:.2f} ms at HBM)"
              for k, v in buckets.items()) + f" [{card}]")
    print(f"roofline: {tag} most bytes: " + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in top) + f" [{card}]")
    del step, args
    torch.cuda.empty_cache()
    return rec


def phase_roofline(seed: int, card: str) -> dict:
    """The counter and the roofline on the card: ``ROOFLINE_STEPS`` each
    counted on ``meta`` and around a real step (gated equal), timed
    uncounted, beside their three-term roofline."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    report = {tag: _roofline_step(tag, arch, mode, seed, card) for tag, arch, mode in ROOFLINE_STEPS}
    report["seconds"] = time.perf_counter() - t0
    print(f"roofline: phase {report['seconds']:.1f} s [{card}]")
    return report


def phase_dryrun_mesh(card: str) -> dict:
    """The mesh dry run: ``DRYRUN_MESH_CELLS`` counted on ``meta`` by
    ``launch.dryrun``, each in a process of its own with no CUDA device
    visible, all started together; one line a cell, gated on its terms."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="dryrun_mesh_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                               "--shape", shape, "--mesh", mesh, "--out", out_dir],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for arch, shape, mesh in DRYRUN_MESH_CELLS]
    report = {}
    try:
        logs = [p.communicate(timeout=DRYRUN_MESH_TIMEOUT_S)[0] for p in procs]
        for (arch, shape, mesh), p, log in zip(DRYRUN_MESH_CELLS, procs, logs):
            if p.returncode:
                raise AssertionError(f"dryrun_mesh: {arch} {shape} --mesh {mesh} failed:\n{log[-3000:]}")
            name = dryrun.MESH_NAMES[mesh]
            with open(dryrun._path(out_dir, arch, shape, name, "baseline")) as fh:
                rec = json.load(fh)
            rl, mem = rec["roofline"], rec["memory_analysis"]
            terms = (rl["compute_s"], rl["memory_s"])
            if rec["status"] != "ok" or not all(np.isfinite(t) and t > 0 for t in terms) \
                    or not rl["collective_s"] > 0:
                raise AssertionError(f"dryrun_mesh: {arch} {shape} {name}: status {rec['status']}, compute "
                                     f"{rl['compute_s']} s, memory {rl['memory_s']} s, collective "
                                     f"{rl['collective_s']} s")
            gb = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 1e9
            print(f"dryrun_mesh: {arch} {shape} {name} ({rec['n_chips']} cards, {rec['per_device_batch']} "
                  f"rows a card): compute {rl['compute_s']:.4g} s, memory {rl['memory_s']:.4g} s, "
                  f"collective {rl['collective_s']:.4g} s ({rl['bottleneck']}; "
                  + ", ".join(f"{ax} {b / 1e9:.3f} GB" for ax, b in rl["collective_bytes_by_axis"].items())
                  + f"), arguments + temp {mem['argument_size_in_bytes'] / 1e9:.3f} + "
                  f"{mem['temp_size_in_bytes'] / 1e9:.3f} = {gb:.3f} GB, fits {rec['fits']}, counted in "
                  f"{rec['trace_s']:.1f} s on the host [{card}]")
            report[f"{arch} {shape} {name}"] = {
                "roofline": rl, "memory_analysis": mem, "fits": rec["fits"], "trace_s": rec["trace_s"],
                "local_config": rec["local_config"], "per_device_batch": rec["per_device_batch"],
            }
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    report["seconds"] = time.perf_counter() - t0
    print(f"dryrun_mesh: phase {report['seconds']:.1f} s [{card}]")
    return report


def phase_lm_train(seed: int, card: str, ckpt_root: str) -> tuple[dict, list[dict]]:
    """LM training on the card through ``launch.train.train_loop``: each of
    ``LM_TRAIN_MODELS`` at its published config (its final checkpoint left
    in ``ckpt_root/<name>``), then the kernel routes' gradients against
    the plain routes' on every family's smoke config and one full-width
    qwen2-1.5b layer, B5 and B6 relaunched bitwise, and the restart
    contract.  Returns the report and the B5 / B6 rows at the training
    shapes."""
    from repro_torch import configs
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    kernels = {"flash_fwd_cuda": flash_kernel.flash_fwd_cuda, "ssd_chunked_cuda": ssd_kernel.ssd_chunked_cuda}
    report, rows, train_args = {}, [], {}
    for name in LM_TRAIN_MODELS:
        own = "flash_fwd_cuda" if name.startswith("qwen2") else "ssd_chunked_cuda"
        flash_kernel.reset_launches()
        ssd_kernel.reset_launches()
        rec, (cfg, model, opt, batch) = _train_full(name, seed, card, {own: kernels[own]},
                                                    os.path.join(ckpt_root, name))
        other = [n for n in kernels if n != own]
        if any(kernels[n].launches for n in other):  # the main path of this model launches only its own
            raise AssertionError(f"{name} launched {other}")
        rec["profile_step"] = _profiled_step(cfg.name, cfg, model, opt, batch, card)
        # the kernel's row at the training shape: layer 0's operands of the
        # trained model on the next batch
        with torch.no_grad():
            x0 = model.embed.to(cfg.compute_dtype)[batch["tokens"]]
            if own == "flash_fwd_cuda":
                blk = model.layers[0]
                q, k, v = blk.qkv(x0, model._positions(*x0.shape[:2]))
                train_args["b6"] = (q, k, v)
                rows.append(_b6_row("lm_train", f"flash_fwd[train {cfg.name} {LM_TRAIN_SHAPE[0]}x{LM_TRAIN_SHAPE[1]}]", q, k, v,
                                    rec["launches"][own], card))
            else:
                args = _ssd_launch_args(model.layers[0].ssd_inputs(x0), cfg.chunk)
                train_args["b5"] = (args, cfg.chunk)
                passes = _b5_passes(rec["profile_step"], rec["launches_per_step"][-1][own])
                rows.append(_b5_row("lm_train", f"ssd_chunked[train {cfg.name} {LM_TRAIN_SHAPE[0]}x{LM_TRAIN_SHAPE[1]}]", args, cfg.chunk,
                                    rec["launches"][own], passes, card))
        report[name] = rec
        del model, opt, batch, x0
        torch.cuda.empty_cache()
    report["repeat"] = _kernels_repeat(train_args, card)
    del train_args
    torch.cuda.empty_cache()

    gen = torch.Generator("cuda").manual_seed(seed)
    report["route_grads"] = {}
    for name in LM_TRAIN_FAMILIES:
        cfg = configs.get_smoke_config(name)
        if cfg.family == "moe":  # no capacity drops: a near tie moves no token out
            cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
        report["route_grads"][name] = _route_grads(f"{cfg.name}", cfg, _smoke_batch(cfg, gen), gen, card)
    cfg1 = configs.get_config("qwen2-1.5b", n_layers=1, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    report["route_grads"]["qwen2-1.5b one layer"] = _route_grads(
        "qwen2-1.5b one full-width layer 1x512", cfg1, _smoke_batch(cfg1, gen, B=1, S=512), gen, card)
    report["restart"] = _restart_check(seed, card)
    report["seconds"] = time.perf_counter() - t0
    print(f"lm_train: phase {report['seconds']:.1f} s [{card}]")
    return report, rows


# the logical meshes of the one card each model's state is restored onto.
# The npz read runs at ~0.4 GB/s, so a restore of qwen2-1.5b's 15.4 GB
# takes 37-51 s: its (1, 4) restore is cut to keep the script well
# inside its time limit (mamba2-370m's 3.7 GB takes both)
RESHARD_MESHES = {"qwen2-1.5b": ((2, 2),), "mamba2-370m": ((1, 4), (2, 2))}
# mesh_train: the last reshard mesh (the (2, 2) state, still held) takes
# MESH_TRAIN_STEPS steps of LM_TRAIN_SHAPE, each data rank's rows in
# MESH_TRAIN_N_MICRO microbatches, beside a one-device run of the same
# steps from the same state with data x n_micro microbatches; the losses
# within MESH_TRAIN_LOSS_ATOL (the reference test's bound: bf16 GEMMs)
MESH_TRAIN_STEPS = 3
MESH_TRAIN_N_MICRO = 1
MESH_TRAIN_LOSS_ATOL = 1e-3
# one step's gradients on (1, 4) with n_micro 2 and grad_shardings,
# bitwise the one-device gradients' slices (deterministic algorithms)
MESH_GRAD_MESH, MESH_GRAD_N_MICRO = (1, 4), 2
# the smoke config in float32 on (2, 2): the CPU test's bounds
# (tests/test_torch_mesh_train.py: loss 1e-6 relative, every parameter,
# m and v 1e-5 relative L2 after two steps of 8 x 16, n_micro 2)
MESH_SMOKE_LOSS_RTOL, MESH_SMOKE_STATE_RTOL = 1e-6, 1e-5


class _PeakRSS:
    """The largest resident set of this process while the block runs,
    sampled from ``/proc/self/statm`` every 2 ms on a thread."""

    def __enter__(self):
        self.peak, self._stop = _rss(), threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, _rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss())


def _rss() -> int:
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _spec_shard_shape(shape, spec, mesh) -> tuple[tuple[int, ...], int]:
    """(shard shape, number of distinct tiles) that ``spec`` gives a
    ``shape`` tensor on ``mesh``, counted from the spec alone."""
    dims, tiles = [], 1
    for dim, part in zip(shape, spec):
        names = () if part is None else (part,) if isinstance(part, str) else part
        n = int(np.prod([mesh.shape[a] for a in names]))
        dims.append(dim // n)
        tiles *= n
    return tuple(dims), tiles


def _reshard_model(name: str, seed: int, card: str, ckpt_dir: str, kernels: dict, own: str) -> dict:
    """Restore ``name``'s training state (params, AdamW m and v, step)
    from ``lm_train``'s final checkpoint onto each of its
    ``RESHARD_MESHES`` (logical meshes of cuda:0) and hold it to the
    unsharded restore.
    ``kernels`` maps each kernel's name to its (module, wrapper); the
    forward from the gathered state must launch ``own`` once a layer and
    no other."""
    from repro_torch import configs
    from repro_torch.checkpoint import checkpoint
    from repro_torch.data import tokens as token_data
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model_api
    from repro_torch.optim import AdamWConfig

    cfg = configs.get_config(name)
    mod = model_api.get_model(cfg)
    step = checkpoint.latest_step(ckpt_dir)
    params_t = specs.params_specs(cfg)
    opt_t = specs.opt_specs(AdamWConfig(), params_t)
    templates = {"params": params_t, "opt": opt_t, "err": {}}
    axes = specs.params_logical_axes(cfg)
    rules = shd.make_rules("train")

    # the unsharded restore, moved to the card: what every re-mesh is held to
    with _PeakRSS() as rss:
        t0 = time.perf_counter()
        host = checkpoint.restore(ckpt_dir, step, templates)
        want = _map_leaves(host, lambda t: t.to("cuda"))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    del host
    flat_want = dict(_flat_leaves(want))
    state_bytes = sum(t.numel() * t.element_size() for t in flat_want.values())
    model = mod.init_params(cfg, torch.Generator("cuda").manual_seed(seed), device="cuda")
    Bb, S = LM_TRAIN_SHAPE
    ds = token_data.TokenStreamConfig(vocab=cfg.vocab, seq_len=S, seed=seed)
    batch = {k: torch.from_numpy(v).cuda() for k, v in token_data.batch_at_step(ds, LM_TRAIN_STEPS, Bb).items()}

    @torch.no_grad()
    def loss_of(params: dict) -> torch.Tensor:
        for n, p in model.named_parameters():
            p.copy_(params[n])
        loss = mod.loss_fn(cfg, model, batch)
        torch.cuda.synchronize()
        return loss

    want_loss = loss_of(want["params"])
    rec = {"config": name, "step": step, "leaves": len(flat_want), "state_bytes": state_bytes,
           "plain_restore_s": plain_s, "plain_peak_host_bytes": rss.peak,
           "loss": float(want_loss), "meshes": {}}
    print(f"reshard: {name} step {step}: {len(flat_want)} leaves, {state_bytes / 1e9:.3f} GB "
          f"(params, AdamW m and v, step); unsharded restore to the card {plain_s:.2f} s, peak host "
          f"RSS {rss.peak / 2**30:.2f} GiB; loss {float(want_loss):.6f} [{card}]")
    for shape in RESHARD_MESHES[name]:
        mesh = make_local_mesh(*shape, devices=("cuda:0",) * 4)
        shardings = {"params": shd.tree_shardings(params_t, axes, rules, mesh),
                     "opt": shd.tree_shardings(opt_t, specs.opt_logical_axes(axes), rules, mesh),
                     "err": {}}
        torch.cuda.empty_cache()
        for kmod, _ in kernels.values():  # the counts of the path's run: restore, forward
            kmod.reset_launches()
        before = _rss()
        with _PeakRSS() as rss:
            t0 = time.perf_counter()
            out = checkpoint.restore_resharded(ckpt_dir, step, templates, shardings)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        leaves = _flat_leaves(out)
        if [p for p, _ in leaves] != list(flat_want):
            raise AssertionError(f"{name} {shape}: restored leaves differ from the unsharded restore's")
        for path, held in leaves:
            if not isinstance(held, shd.ShardedTensor):
                raise AssertionError(f"{name} {shape} {path}: {type(held).__name__}, not a ShardedTensor")
            sub_shape, tiles = _spec_shard_shape(held.shape, held.sharding.spec, mesh)
            positions = held.sharding.positions()
            distinct = {tuple((s.start, s.stop) for s in held.index(*p)) for p in positions}
            shards = [held.shard(*p) for p in positions]
            if (len(shards) != mesh.size or len(distinct) != tiles
                    or any(tuple(t.shape) != sub_shape or t.device != torch.device("cuda", 0) for t in shards)):
                raise AssertionError(f"{name} {shape} {path}: {len(shards)} shards, {len(distinct)} tiles, "
                                     f"shapes {[tuple(t.shape) for t in shards]} under {held.sharding.spec}")
            if not _same_bits(held.full("cuda"), flat_want[path]):
                raise AssertionError(f"{name} {shape} {path}: full() differs from the unsharded restore")
        device_bytes = sum(held.nbytes for _, held in leaves)
        got_loss = loss_of({n: held.full("cuda") for n, held in out["params"].items()})
        launches = {k: fn.launches for k, (_, fn) in kernels.items()}
        if not _same_bits(got_loss, want_loss):
            raise AssertionError(f"{name} {shape}: loss {float(got_loss)!r} after the re-mesh, "
                                 f"{float(want_loss)!r} unsharded")
        if launches != {k: cfg.n_layers if k == own else 0 for k in kernels}:
            raise AssertionError(f"{name} {shape}: launches {launches} in the forward of "
                                 f"{cfg.n_layers} layers, {own} once a layer expected")
        split = sum(1 for _, held in leaves if any(p is not None for p in held.sharding.spec))
        rec["meshes"][f"{shape[0]}x{shape[1]}"] = {
            "restore_s": restore_s, "shard_device_bytes": device_bytes, "peak_host_bytes": rss.peak,
            "host_bytes_before": before, "split_leaves": split, "loss": float(got_loss),
            "launches": launches,
        }
        print(f"reshard: {name} onto a logical ({shape[0]}, {shape[1]}) mesh of cuda:0: restore "
              f"{restore_s:.2f} s, shards {device_bytes / 1e9:.3f} GB on the card ({split} of "
              f"{len(leaves)} leaves split), peak host RSS {rss.peak / 2**30:.2f} GiB (before "
              f"{before / 2**30:.2f}); every leaf's full() bitwise the unsharded restore, shard "
              f"counts and shapes as the specs say; loss {float(got_loss):.6f} bitwise, "
              f"launches {launches} [{card}]")
        del leaves, got_loss
        if shape == RESHARD_MESHES[name][-1]:  # the (2, 2) state, still held, trains
            for kmod, _ in kernels.values():  # the counts of the mesh_train path's run
                kmod.reset_launches()
            rec["mesh_train"], rec["mesh_train_rows"] = _mesh_train(
                name, cfg, seed, card, model, want, flat_want, out, mesh, kernels, own)
        del out
    del want, flat_want, model
    torch.cuda.empty_cache()
    return rec


# the parts of the mesh executor that mesh_train times and profiles:
# the gathers and reduce-scatters of
# ``distributed.sharding`` and the tile AdamW of ``launch.train``
MESH_PARTS = ("all_gather", "reduce_scatter", "tile AdamW")


@contextlib.contextmanager
def _collective_timer(record: dict):
    """Within the block, every ``sharding.all_gather`` and
    ``sharding.reduce_scatter`` call and every ``train.sharded_adamw``
    call of the mesh executor is bracketed by two CUDA events and runs
    inside ``record_function("mesh_train::<part>")``; ``record`` maps
    each part to its event pairs (read after a synchronisation).  An
    event pair spans the device timeline from the call's first launch to
    its last, the device's waits for the host's launches included."""
    from torch.profiler import record_function

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train as train_lib

    def timed(name, fn):
        def wrapped(*a, **kw):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with record_function(f"mesh_train::{name}"):
                start.record()
                out = fn(*a, **kw)
                stop.record()
            record.setdefault(name, []).append((start, stop))
            return out
        return wrapped

    saved = (shd.all_gather, shd.reduce_scatter, train_lib.sharded_adamw)
    shd.all_gather = timed("all_gather", saved[0])
    shd.reduce_scatter = timed("reduce_scatter", saved[1])
    train_lib.sharded_adamw = timed("tile AdamW", saved[2])
    try:
        yield
    finally:
        shd.all_gather, shd.reduce_scatter, train_lib.sharded_adamw = saved


# the smoke config each full-size model's mesh_train holds in float32:
# the two of tests/test_torch_mesh_train.py (granite-8b's smoke config is
# the dense family's there: qwen2's k bias has an exact gradient of zero,
# so its AdamW moments are rounding noise on either side)
MESH_SMOKE_CONFIGS = {"qwen2-1.5b": "granite-8b", "mamba2-370m": "mamba2-370m"}


def _rel_l2_or_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative L2 of a against b, the plain L2 of a - b where b is zero."""
    norm = float(torch.linalg.vector_norm(b.double()))
    diff = float(torch.linalg.vector_norm((a - b).double()))
    return diff / norm if norm > 0 else diff


def _mesh_smoke(name: str, card: str) -> dict:
    """``name``'s smoke config in float32 on a logical (2, 2) mesh of
    cuda:0 against the one-device step with data x n_micro microbatches,
    as ``tests/test_torch_mesh_train.py`` runs them on the CPU: two steps
    of 8 x 16, n_micro 2; the CPU test's bounds."""
    from repro_torch import configs
    from repro_torch.data import tokens as token_data
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model_api
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = configs.get_smoke_config(name)
    opt_cfg = AdamWConfig(lr=1e-3)
    mesh = make_local_mesh(2, 2, devices=("cuda:0",) * 4)

    def fresh():
        m = model_api.get_model(cfg).init_params(cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
        return m.requires_grad_(True)

    m1, m2 = fresh(), fresh()
    o1 = adamw_init(opt_cfg, train_lib.trainable(m1))
    sm, o2, e2 = train_lib.to_mesh(cfg, m2, adamw_init(opt_cfg, train_lib.trainable(m2)), {}, mesh)
    f1 = train_lib.make_step_fn(cfg, opt_cfg, train_lib.TrainConfig(steps=2, batch=8, seq=16, n_micro=4))
    f2 = train_lib.make_step_fn(cfg, opt_cfg, train_lib.TrainConfig(steps=2, batch=8, seq=16, n_micro=2))
    ds = token_data.TokenStreamConfig(vocab=cfg.vocab, seq_len=16, seed=0)
    losses = []
    for step in range(2):
        batch = {k: torch.from_numpy(v).cuda() for k, v in token_data.batch_at_step(ds, step, 8).items()}
        _, o1, _, a = f1(m1, o1, {}, batch, step)
        _, o2, e2, b = f2(sm, o2, e2, batch, step)
        losses.append((float(a["loss"]), float(b["loss"])))
    loss_rel = max(abs(a - b) / abs(a) for a, b in losses)
    worst = 0.0
    for n, p in train_lib.trainable(m1).items():
        for want, held in ((p, sm.params[n]), (o1["m"][n], o2["m"][n]), (o1["v"][n], o2["v"][n])):
            worst = max(worst, _rel_l2_or_diff(held.full("cuda").float(), want.detach().float()))
    print(f"mesh_train: {cfg.name} float32 on (2, 2) vs one device, 2 steps of 8x16, n_micro 2: "
          f"loss max rel diff {loss_rel:.3g} (<= {MESH_SMOKE_LOSS_RTOL:g}), worst parameter / m / v "
          f"rel L2 {worst:.3g} (<= {MESH_SMOKE_STATE_RTOL:g}) [{card}]")
    if not (loss_rel <= MESH_SMOKE_LOSS_RTOL and worst <= MESH_SMOKE_STATE_RTOL):
        raise AssertionError(f"{cfg.name}: the float32 mesh step left the one-device step's bounds: "
                             f"loss {loss_rel:.3g}, state {worst:.3g}")
    return {"losses": losses, "loss_max_rel": loss_rel, "state_worst_rel_l2": worst}


def _mesh_train(name: str, cfg, seed: int, card: str, model, want: dict, flat_want: dict,
                held: dict, mesh, kernels: dict, own: str) -> tuple[dict, list[dict]]:
    """Train ``name`` at full size on the logical ``mesh`` of cuda:0 from
    the sharded state ``held`` that ``restore_resharded`` just gave
    (``launch.train.mesh_step``), beside the one-device steps from the
    same state (``want``, the unsharded restore, which the one-device run
    consumes in place: it runs first and keeps only its losses and final
    parameters), then one step's gradients on (1, 4) with
    ``grad_shardings``, and the smoke config in float32.  Returns the
    report and the kernel's row at a data rank's shape."""
    from repro_torch.data import tokens as token_data
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import AdamWConfig

    t0 = time.perf_counter()
    data = mesh.shape["data"]
    Bb, S = LM_TRAIN_SHAPE
    start = int(want["opt"]["step"])
    opt_cfg = AdamWConfig(lr=1e-3)
    tc = dict(steps=start + MESH_TRAIN_STEPS, batch=Bb, seq=S, seed=seed)
    ds = token_data.TokenStreamConfig(vocab=cfg.vocab, seq_len=S, seed=seed)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in token_data.batch_at_step(ds, start + i, Bb).items()}
               for i in range(MESH_TRAIN_STEPS + 1)]  # the last for the profiled mesh step
    fns = {n: fn for n, (_, fn) in kernels.items()}

    def run(step_fn, state, tag):
        rec = []
        for i, batch in enumerate(batches[:MESH_TRAIN_STEPS]):
            torch.cuda.synchronize()
            before = {n: fn.launches for n, fn in fns.items()}
            t1 = time.perf_counter()
            _, opt, err, metrics = step_fn(state[0], state[1], state[2], batch, start + i)
            torch.cuda.synchronize()
            rec.append({"ms": (time.perf_counter() - t1) * 1e3, "loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "launches": {n: fn.launches - before[n] for n, fn in fns.items()}})
            state = (state[0], opt, err)
        print(f"mesh_train: {name} {tag}: step ms {[round(r['ms'], 2) for r in rec]}, losses "
              f"{[r['loss'] for r in rec]}, launches a step {[r['launches'] for r in rec]} [{card}]")
        return rec

    # the one-device steps first, on the unsharded state, in place
    model.requires_grad_(True)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(want["params"][n])
    one_opt = {"m": want["opt"]["m"], "v": want["opt"]["v"], "step": want["opt"]["step"].clone()}
    n_one = data * MESH_TRAIN_N_MICRO
    torch.cuda.reset_peak_memory_stats()
    one = run(train_lib.make_step_fn(cfg, opt_cfg, train_lib.TrainConfig(n_micro=n_one, **tc)),
              (model, one_opt, {}), f"one device, {n_one} microbatches of {Bb // n_one}x{S}")
    one_peak = torch.cuda.max_memory_allocated()
    one_final = {n: p.detach().clone() for n, p in model.named_parameters()}
    del one_opt
    want.clear()
    flat_want.clear()
    torch.cuda.empty_cache()

    # the mesh steps from the restored (2, 2) state
    rules = shd.make_rules("train")
    state = train_lib.from_sharded_state(model, held, mesh, rules)
    events: dict = {}
    torch.cuda.reset_peak_memory_stats()
    mesh_fn = train_lib.make_step_fn(cfg, opt_cfg, train_lib.TrainConfig(n_micro=MESH_TRAIN_N_MICRO, **tc))
    with _collective_timer(events), shd.activate(mesh, rules):
        steps = run(mesh_fn, state, f"logical ({data}, {mesh.shape['model']}) mesh, {MESH_TRAIN_N_MICRO} "
                    f"microbatch of {Bb // data}x{S} a rank")
        torch.cuda.synchronize()
        mesh_peak = torch.cuda.max_memory_allocated()
        coll_ms = {k: sum(a.elapsed_time(b) for a, b in v) / MESH_TRAIN_STEPS for k, v in events.items()}
        calls = {k: len(v) // MESH_TRAIN_STEPS for k, v in events.items()}
        final_rel = max(_rel_l2_or_diff(state[0].params[n].full("cuda").float(), p.float())
                        for n, p in one_final.items())
        del one_final
        # one more mesh step under the profiler: the device's busy ms in
        # each part (raw kineto events, not key_averages)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            t1 = time.perf_counter()
            mesh_fn(*state, batches[MESH_TRAIN_STEPS], start + MESH_TRAIN_STEPS)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t1) * 1e3
    prof = _device_time(tp, prof_wall, 1)
    under = _device_ms_under(tp, {f"mesh_train::{k}" for k in MESH_PARTS})
    busy_ms = {k: None if under is None else under[f"mesh_train::{k}"] for k in MESH_PARTS}
    del tp
    print(f"profile: mesh_train {name} one mesh step wall {prof_wall:.2f} ms, device busy "
          + ("not measured" if prof["busy_share"] is None
             else f"{prof['device_ms']:.2f} ms ({prof['busy_share']:.1%})")
          + "; device busy ms of: " + ", ".join(
              f"{k} " + ("not measured" if v is None else f"{v:.2f}") for k, v in busy_ms.items())
          + f" [{card}]")
    del state
    held.clear()  # the caller's (2, 2) state: the (1, 4) check needs the room
    torch.cuda.empty_cache()
    per_micro = one[0]["launches"][own] // n_one
    want_launches = {n: data * MESH_TRAIN_N_MICRO * per_micro if n == own else 0 for n in fns}
    loss_diff = [abs(a["loss"] - b["loss"]) for a, b in zip(one, steps)]
    med, med_one = float(np.median([r["ms"] for r in steps])), float(np.median([r["ms"] for r in one]))
    print(f"mesh_train: {name} median step {med:.2f} ms on the mesh, {med_one:.2f} ms on one device; "
          f"device span ms a step (CUDA events): "
          + ", ".join(f"{k} {v:.2f} ({calls[k]} calls)" for k, v in coll_ms.items())
          + f"; peak memory {mesh_peak / 2**30:.2f} GiB on the mesh, {one_peak / 2**30:.2f} GiB one "
          f"device; loss diffs {loss_diff} (<= {MESH_TRAIN_LOSS_ATOL:g}); final parameters worst rel "
          f"L2 {final_rel:.3g} (bf16) [{card}]")
    if not all(d <= MESH_TRAIN_LOSS_ATOL for d in loss_diff):
        raise AssertionError(f"{name}: mesh losses {[r['loss'] for r in steps]} vs one device "
                             f"{[r['loss'] for r in one]}")
    if not all(np.isfinite(r["grad_norm"]) and np.isfinite(r["loss"]) for r in steps):
        raise AssertionError(f"{name}: a gradient or loss of the mesh steps is not finite: {steps}")
    if per_micro != 2 * cfg.n_layers or any(r["launches"] != want_launches for r in steps):
        raise AssertionError(f"{name}: launches a step {[r['launches'] for r in steps]}, "
                             f"{want_launches} expected ({per_micro} a microbatch)")
    launches = sum(r["launches"][own] for r in steps)

    # one step's gradients on (1, 4), n_micro 2, grad_shardings, bitwise
    # the one-device gradients' slices (deterministic algorithms: the
    # embedding's backward accumulates)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    mesh14 = make_local_mesh(*MESH_GRAD_MESH, devices=("cuda:0",) * 4)
    torch.use_deterministic_algorithms(True)
    try:
        loss1, g1 = train_lib.loss_and_grads(cfg, model, batches[0], MESH_GRAD_N_MICRO)
        params = train_lib.trainable(model)
        gs = shd.tree_shardings(params, specs.params_logical_axes(cfg), rules, mesh14)
        sm14 = train_lib.ShardedModel(
            model, {n: shd.ShardedTensor.from_full(p.detach(), gs[n]) for n, p in params.items()}, mesh14, rules)
        loss2, g2 = train_lib.sharded_grads(cfg, sm14, batches[0], MESH_GRAD_N_MICRO, grad_shardings=gs)
    finally:
        torch.use_deterministic_algorithms(False)
    diff = [n for n, g in g1.items()
            if not all(_same_bits(g2[n].shard(*pos), g[gs[n].index(g.shape, *pos)].contiguous())
                       for pos in gs[n].positions())]
    finite = all(bool(torch.isfinite(t).all()) for g in g2.values() for _, t in g.distinct())
    print(f"mesh_train: {name} one step's gradients on a logical {MESH_GRAD_MESH} mesh, n_micro "
          f"{MESH_GRAD_N_MICRO}, grad_shardings: {len(g1) - len(diff)} of {len(g1)} parameters' tiles "
          f"bitwise the one-device gradients' slices, all finite {finite}, loss bitwise "
          f"{_same_bits(loss1, loss2)} [{card}]")
    if diff or not finite or not _same_bits(loss1, loss2):
        raise AssertionError(f"{name}: (1, 4) gradients differ from one device's in {diff[:5]}")
    del g1, g2, sm14

    # the kernel's row at a data rank's shape: layer 0's operands of the
    # trained model on rank 0's rows
    rows = batches[0]["tokens"][: Bb // data]
    with torch.no_grad():
        x0 = model.embed.to(cfg.compute_dtype)[rows]
        tag = f"[mesh_train {cfg.name} {Bb // data}x{S}]"
        if own == "flash_fwd_cuda":
            q, k, v = model.layers[0].qkv(x0, model._positions(*x0.shape[:2]))
            row = _b6_row("mesh_train", "flash_fwd" + tag, q, k, v, launches, card)
        else:
            from repro_torch.kernels.ssd import kernel as ssd_kernel

            args = _ssd_launch_args(model.layers[0].ssd_inputs(x0), cfg.chunk)
            passes = _b5_passes(_profile(lambda: ssd_kernel.ssd_chunked_cuda(*args, cfg.chunk)), 1)
            row = _b5_row("mesh_train", "ssd_chunked" + tag, args, cfg.chunk, launches, passes, card)
    model.requires_grad_(False)
    smoke = _mesh_smoke(MESH_SMOKE_CONFIGS[name], card)
    report = {
        "mesh": [data, mesh.shape["model"]], "n_micro": MESH_TRAIN_N_MICRO, "steps": steps,
        "one_device": one, "median_step_ms": med, "one_device_median_step_ms": med_one,
        "span_ms_per_step": coll_ms, "calls_per_step": calls, "peak_memory": mesh_peak,
        "profiled_step": {"wall_ms": prof_wall, "device_ms": prof["device_ms"],
                          "busy_share": prof["busy_share"], "parts_busy_ms": busy_ms},
        "one_device_peak_memory": one_peak, "loss_diffs": loss_diff, "final_params_worst_rel_l2": final_rel,
        "launches_per_microbatch": per_micro, "grads_1x4_bitwise": True, "smoke_f32": smoke,
        "seconds": time.perf_counter() - t0,
    }
    print(f"mesh_train: {name} {report['seconds']:.1f} s [{card}]")
    return report, [row]


def _flat_leaves(tree, prefix=()) -> list:
    """(path, leaf) of a dict tree, keys in order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in _flat_leaves(v, prefix + (k,))]
    return [("/".join(prefix), tree)]


def phase_reshard(seed: int, card: str, ckpt_root: str) -> dict:
    """The elastic re-mesh of training state: qwen2-1.5b (B6) and
    mamba2-370m (B5) restored from ``lm_train``'s final checkpoints onto
    their ``RESHARD_MESHES`` of the card, then one forward loss at
    ``LM_TRAIN_SHAPE`` from the gathered state."""
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel

    t0 = time.perf_counter()
    kernels = {"flash_fwd_cuda": (flash_kernel, flash_kernel.flash_fwd_cuda),
               "ssd_chunked_cuda": (ssd_kernel, ssd_kernel.ssd_chunked_cuda)}
    report, rows = {}, []
    for name in LM_TRAIN_MODELS:
        own = "flash_fwd_cuda" if name.startswith("qwen2") else "ssd_chunked_cuda"
        report[name] = _reshard_model(name, seed, card, os.path.join(ckpt_root, name), kernels, own)
        rows += report[name].pop("mesh_train_rows")
    report["seconds"] = time.perf_counter() - t0
    report["mesh_train_seconds"] = sum(report[n]["mesh_train"]["seconds"] for n in LM_TRAIN_MODELS)
    print(f"reshard: phase {report['seconds']:.1f} s, of which mesh_train "
          f"{report['mesh_train_seconds']:.1f} s [{card}]")
    return report, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the full report as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.conv3d import kernel as conv_kernel
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.stmul import kernel, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_s = {}

    def mark(name: str) -> None:  # seconds since the last mark
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())

    report = {"build": phase_build({
        "stmul": kernel, "ssd": ssd_kernel, "flash": flash_kernel, "conv3d": conv_kernel,
    })}
    report["build"]["flash_checks"] = check_flash_build(flash_kernel, report["build"]["flash"]["path"])
    report["build"]["ssd_sass"] = check_ssd_build(ssd_kernel, report["build"]["ssd"]["path"])
    report["build"]["conv3d_sass"] = check_conv3d_build(
        report["build"]["conv3d"]["path"], report["build"]["conv3d"]["warnings"])
    mark("build")
    report["serve"] = phase_serve(kernel, args.seed)
    mark("serve")
    report["sched"] = phase_sched(kernel, args.seed, report["serve"]["modes"]["pooled"]["frames_per_s"])
    mark("sched")
    rows = phase_kernels(kernel, ref, args.seed, report["serve"]["launches"])
    mark("kernels")
    report["lm"], ssd_rows = phase_lm(args.seed)
    rows += ssd_rows
    mark("lm")
    report["lm_dense"], flash_rows = phase_lm_dense(args.seed)
    rows += flash_rows
    mark("lm_dense")
    report["classify"], classify_rows = phase_classify(args.seed, kernel)
    rows += classify_rows
    mark("classify")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    report["c3d"], c3d_rows = phase_c3d(args.seed, card)
    rows += c3d_rows
    mark("c3d")
    report["train"], train_rows = phase_train(args.seed, kernel)
    rows += train_rows
    mark("train")
    # last, so the phases before them run in the process state they ran
    # in before these two existed
    report["replica"] = phase_replica(kernel, args.seed)
    mark("replica")
    report["ckpt"] = phase_ckpt(args.seed)
    mark("ckpt")
    report["mesh"], mesh_rows = phase_mesh(kernel, ref, args.seed, card)
    rows += mesh_rows
    mark("mesh")
    report["lm_zamba"], zamba_rows = phase_lm_zamba(args.seed, card)
    rows += zamba_rows
    mark("lm_zamba")
    report["lm_moe"], moe_rows = phase_lm_moe(args.seed, card)
    rows += moe_rows
    mark("lm_moe")
    report["lm_mm"], mm_rows = phase_lm_mm(args.seed, card)
    rows += mm_rows
    mark("lm_mm")
    report["roofline"] = phase_roofline(args.seed, card)
    mark("roofline")
    # lm_train leaves its final checkpoints for reshard, which restores them
    ckpt_root = tempfile.mkdtemp(prefix="lm_train_")
    try:
        report["lm_train"], train_lm_rows = phase_lm_train(args.seed, card, ckpt_root)
        rows += train_lm_rows
        mark("lm_train")
        report["reshard"], mesh_train_rows = phase_reshard(args.seed, card, ckpt_root)
        rows += mesh_train_rows
        mark("reshard")
        phase_s["mesh_train"] = report["reshard"]["mesh_train_seconds"]
        phase_s["reshard"] -= phase_s["mesh_train"]
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    report["dryrun_mesh"] = phase_dryrun_mesh(card)
    mark("dryrun_mesh")
    report["phase_s"] = phase_s
    print("phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items())
          + f"; all {sum(phase_s.values()):.1f} s [{card}]")
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(
            f"kernel: {r['name']:36s} {r['ms']:8.4f} ms (bound {r['bound_ms']:.4f} "
            f"{r['bound_by']}, plain {r['plain_ms']:.3f}, library "
            f"{lib}) launches {r['launches']} max_abs_err {r['max_abs_err']:.3g}"
        )
    report["card"] = card
    report["kernels"] = rows
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
