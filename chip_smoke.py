"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi); TF32 off for matmul
   and cuDNN, so float32 stays float32, and cuDNN on its deterministic
   algorithms, picked by heuristics;
2. build every CUDA kernel of the main paths from the sources in this
   checkout (``src/repro_torch/csrc``), one nvcc per source, all at once
   (ptxas' registers and spills logged per kernel instance), and count
   each draw kernel's instructions per draw by pipe in its SASS
   (`repro_torch.kernels.sass`: the operations its bound counts); the
   tensor-core flash kernels' instances (bf16 at hd 16, 32, 64 and 128
   and hd 112 on the hd-128 one; float32 at hd 32, 64 and 128, hd 16 on
   the hd-32 one and hd 112 on the hd-128 one) must hold ``HGMMA``
   (wgmma) and ``UTMALDG`` (TMA loads) in their SASS;
3. each kernel against its plain PyTorch version on the card, at every
   shape the main paths give it, with inputs built as the channel
   backends and the sharded round build them, plus a few edge shapes
   (max |y_kernel - y_plain| / max |y_plain| <= 1e-4, and two launches
   give identical bits), among them Fig. 3's two hops at the CIFAR CNN's
   N = 154,197 symbols, (B, U, K, N) = (4, 20, 100, 154197) with a
   ragged last N tile and (1, 4, 100, 154197); `fused_mac_partials` then
   `fused_partials_reduce` must give `fused_mac`'s output bit for bit at
   every such shape, at a tile of Fig. 3's 2x5 mesh and at the
   scale_u65536 1x1 one (there the plain versions run in phase 7);
   participation's precoded users (a Bernoulli round's transmit
   multipliers with byzantine users: absent rows exactly 0, byzantine
   rows -2 x) through `fused_mac` (bit for bit its plain version) and
   `ota_combine` at fig2's cluster, IS->PS and conventional hops, and
   through the partials and fold on a padded tile of fig2 on 3x2 (bit
   for bit `fused_mac`); flash
   attention (through `flash_attention`,
   on the kernel `flash_route` picks, which alone must count both
   launches: bf16 on the tensor cores, ``flash_mha_wgmma``, float32 on
   the tensor cores in 3xTF32, ``flash_mha_tf32``, at every head dim)
   against its plain version, first at one tile (L = S = 64, one head:
   hd 16 and 32, both dtypes), then at qwen2-0.5b's prefill shape (B 4,
   L 4096, bf16 and f32), its heads at L 200 (128-row tiles straddle
   fold groups; also f32, both masks) and L 77, the hd-128 shapes of
   qwen2-1.5b (also bidirectional, and f32 at L 200 and L 77) and
   qwen3-4b (f32 bidirectional at L 1000), the serving example's
   reduced model at B 4, L 4096 (hd 32, bf16 and f32),
   ``tests/test_flash_attn.py``'s shapes (hd 16, 32, 64 and 128, f32
   and bf16, both masks) and zamba2-7b's hd 112 (one tile, its prefill
   shape B 4, L 4096, 32 heads over 32 KV heads in both dtypes and
   masks, L 1000, and 8 heads over 2 at L 200): f32 within 1e-5 of max |o|,
   bf16 within that plus one bf16 ULP of each value (both sides round
   once from float32), two launches identical; seed batching
   (``batch="vmap"``): `fused_mac` and `ota_combine` at 4 seeds of
   fig2's and scale_u256's hops and `fused_mac` at 2 seeds of Fig. 3's
   (the fig3_cifar_fused vmap run's) in one launch (the gains shared
   with a seed stride of 0; `ota_combine` at B = 1 split over a
   cluster), bit for bit the unbatched launches and within 1e-4 of the
   plain version with its seed axis (at Fig. 3's cluster hop the plain
   version computes two windows of 4,096 symbols, its first and its
   last, through ``n_base``: a symbol's output depends on its column
   alone, and the full hop at 2 seeds would not fit beside the plain
   version's intermediates);
4. the main paths on ``cuda`` at full width, every launch count set to
   0 just before each run and read just after:
   - through `repro_torch.sim.SweepRunner`: ``scale_u256`` as
     registered, ``fig2_iid`` at the paper's sizes with the fused
     backend and with faithful fidelity's default ``reference`` backend
     (no kernel), and ``fig2_iid`` as registered (equivalent backend),
     2 seeds each; `fused_mac` launches exactly twice per round per
     seed on the fused runs (one cluster hop, one IS->PS hop);
   - ``fig3_cifar`` (the CIFAR CNN) at the paper's sizes (C 4, M 5,
     K = K_ps = 100, batch 128, tau 5, n_train 20,000, n_test 1,000,
     Adam at 1e-3), its 400 rounds cut to 1: as registered (equivalent
     channel, no kernel), faithful with the fused backend (2
     `fused_mac` launches per round per seed), and on the sharded
     engine, 1x1 and 2x5, u_sharded, 2 seeds each; the sharded runs'
     final state and metrics against the single engine's (logged); the fused
     run again with its 2 seeds as one vmapped program through the
     chunked driver (2 `fused_mac` launches a round for both seeds, in
     its trace), held to its map run by accuracy and the update's norm
     off the conv biases (as phase 5 holds Adam);
     whether the CNN's gradient runs under
     ``torch.use_deterministic_algorithms(True)`` (logged);
   - every run above and below passes ``batch="map"`` (seeds one by
     one) where it holds a per-seed launch count or a bitwise contract
     with the sharded engine, unless it is named vmap;
   - seed batching (``batch="vmap"``, the sweep's default):
     ``fig2_iid`` fused and slab with 4 seeds, ``fig2_drop50`` fused
     and ``scale_u256`` with 2, 5 rounds (scale_u256 its 2): the OTA
     kernel launched once a hop for all seeds (2 a round), every seed
     within the W-HFL bounds (1e-4 / 2/n_test / 1e-4) of its own map
     run on the card, and through the chunked driver below;
   - every SweepRunner run above and every sharded CLI run below again
     through the chunked driver (each eval window one CUDA graph,
     captured and replayed once on throwaway copies before the drive;
     the fig3_cifar runs on their first seed alone, against that seed
     of their stepwise runs, and sharded 1x1 not at all, for the run's
     time):
     bit for bit its stepwise run (final state and every metric; the
     CLI runs, which keep no state, by their metrics), with the
     stepwise run's launch counts in a `torch.profiler` trace of the
     chunked drive (a trace that lost device records, reading fewer and
     none more, is taken again, up to 3 times in all); a run with no
     kernel of ours shows it by counters that read 0 through its eager
     runs and captures.  A graph replay runs no Python, so the wrappers'
     counters do not see it: the chunked runs' counts are logged, not
     added to the kernels line, whose launches are the stepwise runs'
     counters alone;
   - the participation family at fig2's paper sizes, 5 rounds, 2 seeds:
     ``fig2_drop50`` and ``fig2_byzantine3`` faithful/fused (2
     `fused_mac` launches per round and seed), ``fig2_straggler``
     faithful/slab_kernel (2 `ota_combine` launches per round and seed)
     and ``fig2_byzantine1_median`` as registered (the orthogonal
     per-user hop, no kernel of ours), each through both drivers with
     the card's realised masks against the CPU's bit for bit;
     ``fig2_drop50`` fused on the sharded engine, u_sharded, on 1x1 and
     on 2x4 (M padded to 8), each bit for bit the single engine (every
     engine's gradients run in passes of M users), and the 2x4 cluster
     hop on precoded deltas bit for bit the single engine's;
   - the sweep's telemetry, guard, faults and checkpoints (after the
     sharded CLI runs below) on ``fig2_iid`` fused at the paper's sizes,
     5 rounds, 2 seeds: ``telemetry`` with guard ``skip_round`` bit for
     bit the plain run in every other output through both drivers (2
     `fused_mac` launches per round and seed; the chunked telemetry
     equal to the stepwise one; the block within 1e-4 of the CPU's over
     2 rounds); ``poison=nan@2:0:1`` with ``zero_fill`` (finite, one
     trip a seed) and ``halt`` (stops after round 3), both drivers bit
     for bit alike; a subprocess killed after round 3 (exit 173) and a
     second one resuming from its checkpoint, per driver and seed mode
     (four side by side), bit for bit the uninterrupted run
     (final carry and metrics);
     ``scale_u256`` sharded 2x4 u_sharded with telemetry bit for bit the
     single engine's; ``fig2_iid`` slab (3 rounds) with telemetry bit
     for bit the plain slab run; the CLI's ``--profile`` Chrome trace
     holding `fused_mac`'s device records (retaken if lossy); and
     ``fig2_iid`` fused at batch 500 sharded on 2x4, 2x5 and 4x5 bit for
     bit the single engine;
   - the Fig. 2 driver ``examples/whfl_mnist_torch.py --ota faithful
     --backend slab_kernel --IT 8 --seeds 2`` at its paper defaults,
     its 2 seeds as one vmapped program: `ota_combine` launches rounds
     x (I + 1) times for W-HFL, rounds times for conventional FL and
     never for the error-free baselines, each for both seeds, 46 in
     all;
   - ``fig2_iid`` quick at faithful fidelity with the mode's default
     ``reference`` backend, 2 seeds: no kernel launches;
   - the sharded engine through the sweep CLI (``--exec sharded``):
     ``scale_u256`` (2 seeds) on meshes 1x1, 2x4 and 3x5 (padded to
     6x65) with ``--combine u_sharded`` and on 2x4 with ``gathered``,
     ``scale_u16384`` on 1x1 with both combines and ``scale_u65536`` as
     registered on 1x1 with ``u_sharded``: per round and seed
     `fused_mac_partials` launches mc x mu times, `fused_partials_reduce`
     mu times and `fused_mac` once (u_sharded), or `fused_mac`
     mc x mu + 1 times (gathered); each run's peak device memory through
     both drivers (logged); each scale_u256 run's final model is
     held against the single engine's, bit for bit where it is, with
     the largest gap printed where it is not;
   - dense-LM serving (`repro_torch.launch.serve`) of qwen2-0.5b as
     registered (24 layers, d 896, vocab 151936, bf16 compute, f32
     weights from a seed): `build_prefill_step` on 4 prompts of 4,096
     tokens (prefill_32k cut from batch 32 x 32,768), exactly 24
     launches of the bf16 tensor-core flash kernel and none of the
     others, by the count and in the profiler; the same prefill at
     float32 compute, 24 of the float32 tensor-core kernel and none of
     the others (and 24 of each of its two pre-pass kernels in the
     profiler); qwen2-1.5b at full width (hd 128), its depth cut to 4
     layers, prefilled at float32 compute (1 prompt of 4,096 tokens): 4
     launches of the float32 tensor-core kernel and none of the others;
     the serving example's model (qwen2-0.5b's reduced() config, hd 32,
     2 layers) prefilled at B 4 x L 4096 at its bf16 compute (2 launches
     of the bf16 tensor-core kernel, none of the others) and at float32
     compute (2 of the float32 one, none of the others); one warm
     `build_decode_step` step against `cache_specs`' prefilled cache
     (decode_32k cut from batch 128 to 8, cache 32,768), then 8
     requests answered: a 32-token prompt streamed into an empty
     cache, 16 greedy tokens; ``examples/serve_decode_torch.py`` at its
     defaults (no kernel: it streams its prompt through the decode);
   every other count stays 0, and every metric must be finite;
5. the main paths' output against a reference: ``scale_u256`` as
   registered, and ``fig2_iid`` at the paper's sizes with the
   ``slab_kernel`` and the ``reference`` backends for 1 round, 2 seeds
   as every fig2 run of this phase, run on the CPU (plain versions)
   with the same seeds, must agree with their
   runs on the card (kernels, and cuBLAS's complex products without
   TF32); ``fig2_iid`` as registered (no kernel) runs beside them as
   the control; ``scale_u256`` on the sharded engine (2x4, u_sharded)
   the same way; qwen2-0.5b's full-width `prefill_logits` (B 1,
   L 256) on the card (24 launches of one flash kernel) against the CPU
   (plain version, the same weights copied off the card): at f32
   compute (the 3xTF32 kernel) within 1e-4 of max |logit|, at bf16
   compute (the bf16 tensor-core kernel) within 5e-2 (the CPU tests'
   bf16 bound against JAX), and its streamed decode (B 2, T 64, f32)
   against its prefill on the card within rtol = atol = 5e-3; phase 4's
   two prefills of the serving example's model (B 4, L 4096) against
   the same prefills on the CPU: bf16 within 5e-2 of max |logit|,
   float32 within 1e-4; ``fig3_cifar`` faithful/fused for 1 round with
   its users and batch cut (C 2, M 2, batch 32; the CPU's plain combine
   would take minutes at full size), with SGD within all three bounds,
   and as registered (Adam) within the accuracy bound, its loss and
   model gaps logged: Adam turns the conv biases' rounding noise (their
   gradient is zero in exact arithmetic) into steps of up to the
   learning rate, and the OTA hops carry those into the coordinates
   packed with them; so Adam on the card is also held on the error-free
   channel (``fig3_cifar_ideal``, the same cut), within the accuracy
   bound and, in learning-rate units as tests/test_torch_cifar.py holds
   it, the conv biases within 2 lr per local step and every other entry
   within 0.1 lr; ``fig2_drop50`` faithful/fused and
   ``fig2_byzantine1_median`` for 2 rounds, card vs CPU, within the
   W-HFL bounds;
6. where the time goes: one seed of each SweepRunner run of phase 4
   (the reference run cut to 1 round), of ``fig2_iid`` with the
   slab backend, of ``fig2_drop50`` fused through both drivers,
   through `SweepRunner.run_scenario`, warm, then again under
   `torch.profiler`; wall ms per round from the runner's
   ``drive_seconds``, device time per round from the device ops inside
   the runner's ``SweepRunner.drive`` range; also one seed of
   ``scale_u256`` (2x4, u_sharded, with its peak device memory) on the
   sharded engine (Fig. 3's profiles went with phase 11's arrival,
   fig2_byzantine1_median's and scale_u65536's with phase 12's; phase 4
   logs the sharded CLI runs' peak memory); rounds/s
   of both drivers, each warmed, for fig2_iid fused, scale_u256 and
   sharded scale_u256 2x4; one warm qwen2-0.5b prefill
   (B 4, L 4096) at bf16 and at float32 compute, one warm decode step
   (B 8, cache 32,768), and phase 4's qwen2-1.5b float32 prefill and
   both reduced prefills: device ms, busy share, each flash record's
   share (the
   tf32 record's with its pre-pass, also given alone), device ops per
   call;
7. a Fig. 3 round's parts, each timed alone queued behind a spin (all
   users' dropout masks for a step, one user's gradient, a step's
   gradients of all 20 users one at a time, in one vmapped pass and in
   vmapped chunks of 5, with each one's gap to the first, Adam over all
   users); kernel and plain times with CUDA events at the kernels' largest
   main-path shapes, in turns (a plain version that takes a second or
   more a call, at fig3's cluster hop, scale_u65536 and prefill_32k,
   timed in one cold call before the kernel) (for `fused_mac` also at
   Fig. 3's cluster hop, for
   `ota_combine` at the Fig. 2 driver's three
   shapes and scale_u256's, with its cluster size and its time with
   the calls queued behind a spin kernel, since at B = 1 the wrapper's
   host time bounds back-to-back launches), beside the least
   time the card could take for the same work (``fused_mac_bound_ms``,
   ``ota_combine_bound_ms``,
   ``partials_bound_ms``, ``reduce_bound_ms``); `fused_mac` and
   `ota_combine` at 4 seeds of fig2's cluster and IS->PS hops in one
   launch against the 4 unbatched launches, in turns, beside 4 times
   one seed's bound; `fused_mac` at Fig. 3's IS->PS hop (1, 4, 100,
   154197) and the partials at a tile of its 2x5 mesh (4, 10, 100,
   30840); at scale_u65536 1x1 both
   partial kernels are also held to the output of the plain calls
   timed there, as in phase 3; the whole slab cluster
   hop (emulated draw of the slab and the combine) against the fused hop
   at the scale_u256 shape, and the u-sharded cluster hop against the
   gathered one at the scale_u16384 shape; the tensor-core flash kernel
   at qwen2-0.5b's prefill shape, at prefill_32k's length (B 1,
   L 32,768, one layer) and at a rank's 7 heads over 1 KV head under
   phase 11's "model" 2 (B 1, L 4,096), the float32 tensor-core one at the prefill
   shape in float32 and at qwen2-1.5b's float32 prefill shape (B 1,
   L 4096, hd 128), and both at the reduced prefill's shape (B 4,
   L 4096, hd 32) and at hd 16 on it (with their times queued behind a
   spin as well, since they near the launch gap), each against its
   plain version, the library's
   `scaled_dot_product_attention` on the same inputs (timed as a
   yardstick only, held to the backend it chose; for float32 on k and v
   expanded to H heads beforehand, as its GQA mode would send float32
   to the MATH backend), ``flash_bound_ms`` (bf16 at the tensor-core
   peak, float32 at the 3xTF32 rate, and also at the TF32 peak) and
   ``exp_floor_ms`` (one exp2 per kept pair on the MUFU pipe), and both
   at zamba2-7b's prefill shape (B 4, L 4096, 32 heads of hd 112);
   both kernels with a query offset (``q_offset``: a "q_seq" rank's
   1,024 rows of qwen2-0.5b's 4,096 against all 4,096 keys, 14 heads
   over 2 KV heads, at offsets 0 and 3,072, and at 3,072 with a window
   of 1,024; ``OFFSET_CASES``), in both dtypes, against the plain
   version with the offset (phase 3's gates; the launches counted on
   `flash_mha.offset_launches` past offset 0) and against the same rows
   of the whole call (its gap logged, held to the same gates), each
   timed beside the plain version, the library's SDPA with the
   equivalent boolean mask and the bound of the pairs the rows keep;
   and each phase-11 rank's flash call at float32 timed alone
   (``RANK_FLASH``: the four "q_seq" ranks' rows, whose causal work
   grows 1 : 3 : 5 : 7, the replicated attention's, qwen2-1.5b's 3
   heads over 1 KV head);
8. the LM families at full width through `repro_torch.launch.serve`,
   weights from `lm.init_params` at seed 0, one arch at a time
   (``FAMILY_RUNS``): mamba2-780m (24 of its 48 layers), zamba2-7b (15
   of its 81: 2 groups of 6 Mamba2 layers, each followed by the shared
   attention block at hd 112, and 3 more), qwen3-moe-235b-a22b (1 of its
   94 layers, 128 experts, top 8), seamless-m4t-medium (12 encoder + 12
   decoder layers) and llava-next-34b (4 of 60 layers): a prefill of 4 x 4,096
   positions at bf16 (llava's 2,880 patch embeddings + 1,216 tokens;
   seamless' 4,096 tokens over 1,024 source frames; zamba2 also at
   float32), exactly one flash launch per attention layer of the bf16
   (float32) tensor-core kernel and none of the others, by the count
   and in the profiler (none for mamba2; 2 for zamba2; 24 for
   seamless, 12 of them bidirectional), finite logits, and its time
   (wall, device ms, busy share, each flash record's share, device ops:
   warm, then under `torch.profiler`); one warm decode step at (batch,
   cache) = (128, 32,768) for mamba2 (its O(1) state), (2, 32,768) for
   zamba2 and (8, 32,768) for the others, through `build_decode_step`
   (no kernel of ours), finite, and its time; 2 x 32 tokens streamed
   through an empty cache against their prefill, float32, within rtol
   = atol = 5e-3 (a MoE at a capacity that drops nothing, the vlm
   without patches, the encdec with its encoded frames in the cache);
   then each family (and arctic-480b, the MoE's dense residual) at its
   reduced config, card vs CPU on the same weights: prefill at float32
   within 1e-4 of max |logit| and at bf16 within 5e-2 (a bf16 MoE: at
   most 3% of a layer's tokens may route apart, and the rows whose
   routes agree are held), and a decode step at float32 within 1e-4;
9. federated LM training (`repro_torch.launch.train`, W-HFL over the
   equivalent channel) of qwen2-0.5b as registered (24 layers, d 896,
   14 heads over 2 at hd 64, vocab 151,936, remat on) at train_4k's
   sequence of 4,096, bf16 compute and float32 parameters, its global
   batch of 256 cut to C 2 x M 2 users of 2 rows, weights from seed 0:
   the structural step (tau = I = 1, the equivalent channel under a
   quiet radio; one row a user and AdamW, its first step phase 11's
   ZeRO-1 and FSDP reference) for 2 steps on one batch (with
   ``--training`` the second under `torch.profiler`: device ms, busy
   share, device ops, flash ms and launches, the threefry emulation's
   share), the loss falling; local SGD (tau = I = 2, outer "add", batch
   16, depth cut to 2 layers), 1 step; the fused
   step (grad_accum 2), 1 step; one fused step at float32 compute, its
   depth cut to 4 layers (the float32 tensor-core kernel under
   autograd); each with finite loss and edge power, wall ms a step,
   peak memory, and exactly layers x 2 (remat) flash launches per
   micro-forward; the attention's gradient route
   (`flash_attention_autograd`: the kernel forward, `attention_vjp`'s
   float32 recompute) against autograd through `flash_attention_plain`
   at (2, 4096, 14, 2, 64) in bf16 (2e-2 of max |g|) and float32
   (1e-5), with the backward's time against the kernel forward's; card
   vs CPU: reduced qwen2-0.5b, 2 structural and 2 fused steps from one
   state, and one `lm_loss` and gradient per reduced family, float32;
10. sliding-window attention: (a) each flash kernel with a window
   against its plain version in both dtypes (``WINDOW_CASES``:
   qwen2-0.5b's (4, 4096, 14, 2, 64) at W 1,024 both ways, hd 32 and 16
   at W 100, zamba2-7b's hd 112 and qwen2-1.5b's hd 128 at W 1,024,
   W 1, straddling tiles and ragged lengths), counted as windowed
   launches, with the same gates as phase 3; a window of L, L + 1 or
   2^30 keys bit for bit the unwindowed launch; five shapes timed in
   turns with the plain version beside the library's SDPA with the
   boolean window mask and the bound of the pairs the window keeps;
   (b) qwen2-0.5b as registered with its ``long_context_window`` of
   8,192 as ``sliding_window``, prefilled at bf16 at prefill_32k's full
   32 x 32,768: exactly 24 windowed launches of the bf16 kernel, by the
   count and in the profiler, finite logits, warm wall ms, device ms,
   busy share and peak memory; (c) long_500k decode (batch 1, 524,288
   positions): qwen2-0.5b's ring caches of 8,192 slots from pos 524,287
   (the slot wraps to 0) and mamba2-780m's O(1) state, 4 steps each, ms
   a step and peak memory; (d) reduced dense, encdec and hybrid configs
   with a window of 12, float32, card vs CPU: prefill logits, `lm_loss`
   and its gradient within 1e-4; the windowed attention gradient at
   (2, 4096, 14, 2, 64) W 1,024 against autograd through the plain
   version within phase 9's bounds, timed against the kernel forward
   and the unwindowed backward;
11. W-HFL training with one process per mobile user (`launch.ranks`:
   processes spawned by `torch.multiprocessing`, joined through a
   `FileStore`; the mesh (pod, data, model) built on their world and
   refined to (pod, cluster, user, model); the hops as collectives over
   each rank's `user` and `(pod, cluster)` groups; each rank drawing
   and holding its shards of the state): NCCL at world size 1
   (qwen2-0.5b at full width, 8 of its 24 layers, 4,096 positions, one
   row, AdamW, one step) against the one-card step at {"data": 1}; four gloo ranks sharing
   the card at (1, 2, 2, 1): the replicated state with the outer "add"
   (depth cut to 2 layers) against its own one-card step, and ZeRO-1
   and FSDP with AdamW against phase 9's structural run (its first
   step), each rank's parameters, moments, losses and edge power bit
   for bit; tensor parallelism at (1, 1, 2, 2) (2 users, "model" 2,
   AdamW, float32 compute, 8 layers) against the one-card step of 2
   users within TP_BOUNDS; and at "model" 4 on (1, 1, 1, 4) (one user,
   AdamW, float32) against the one-card step of one user within
   TP_BOUNDS: qwen2-0.5b's 14 heads (12 of its 24 layers), which do not
   divide, through the "q_seq" route (``seq_shard_attn``: each rank
   1,024 rows, the flash kernels with a query offset past the first)
   and through the replicated attention (the same one-card reference),
   and qwen2-1.5b's 12 heads split beside its 2 KV heads replicated (8
   of its 28 layers) (the gloo cases in one launch); each rank's peak memory,
   step seconds, seconds inside collectives, collective groups and
   flash launches (with a query offset, under "q_seq");
12. the sharded W-HFL sweep with one process per shard
   (`ShardedSweepRunner(ranks=...)`, `launch.ranks.sweep_worker`: each
   rank trains its own users, launches the hop's kernels on its own
   tile and meets the others in all_gathers over ``user`` and
   ``cluster``): fig2_iid faithful/fused at the paper's sizes (5
   rounds, 2 seeds) on 2x2 as four gloo ranks sharing the card,
   gathered and u_sharded through both drivers in one launch (the
   chunked driver replays the graphs between the collectives),
   scale_u256 on 2x4 u_sharded as eight gloo ranks (both drivers, one
   launch), and scale_u256 through the sweep CLI (``--ranks nccl``,
   both drivers) on 1x1 under NCCL at world size 1;
   every rank's final state and metrics bit for bit the one-process
   sharded run on the card (phase 4's scale_u256 ones), every stepwise
   rank's launches those of its tile (u_sharded: a partial combine and
   a fold a hop; gathered: a `fused_mac` a hop; and the IS -> PS
   `fused_mac` a round, each a round and seed); each rank's rounds/s,
   seconds inside collectives and peak memory;
13. the run's seconds, one JSON line of kernel records, then the last
   line ``{"ok": true, "device": {...}}``.

Without CUDA, or without the rest of the repository beside it, it exits
non-zero before printing any result.  ``python3 chip_smoke.py
--training`` builds the flash kernels and runs phase 9 alone,
``--window`` phase 10 alone, ``--ranks`` phase 7's query-offset checks
and phase 11 alone (with its own one-card reference for the gloo
ranks), ``--sweep-ranks`` phase 12
alone (with its own one-process references).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels.trace_probe import (  # noqa: E402
    SPIN_KERNEL, TRACE_ATTEMPTS, count_drives, device_trace, drive_ops,
    lead_in, raw_events)
TOL = 1e-4
THETA_RTOL = 1e-4

SOURCES = ("fused_mac", "ota_combine", "flash_attn_wgmma",
           "flash_attn_tf32")                               # csrc/<name>.cu
# each kernel's record name -> (source, its __global__ function)
KERNELS = {"fused_mac": ("fused_mac", "fused_mac_kernel"),
           "ota_combine": ("ota_combine", "ota_combine_kernel"),
           "fused_mac_partials": ("fused_mac", "fused_partials_kernel"),
           "fused_partials_reduce": ("fused_mac", "fused_reduce_kernel"),
           "flash_mha_wgmma": ("flash_attn_wgmma", "flash_wgmma_kernel"),
           "flash_mha_tf32": ("flash_attn_tf32", "flash_tf32_kernel")}
# each kernel's record name -> its __global__ function, as traces name it
KERNEL_FUNCTIONS = {name: fn for name, (_, fn) in KERNELS.items()}
# the tensor-core flash kernels and their template instances (bf16 at hd
# 16, 32, 64, 128 and hd 112 on the hd-128 one; float32 at hd 32, 64,
# 128, hd 16 on the hd-32 one and hd 112 on the hd-128 one): wgmma
# (HGMMA) fed by TMA (UTMALDG) in each one's SASS
TENSOR_CORE_FLASH = {"flash_mha_wgmma": 5, "flash_mha_tf32": 5}
# the kernels a flash record's entry point launches before its own, once
# per call: the tf32 kernel's pre-pass (K and V^T split into scratch)
FLASH_PREPASS = {"flash_mha_tf32": ("tf32_split_k_kernel",
                                    "tf32_split_vt_kernel")}
# the flash wrappers' route (`flash_route`: the source) -> the record
FLASH_RECORDS = {src: name for name, (src, _) in KERNELS.items()
                 if src.startswith("flash_attn")}
# H100 SXM peaks at the full 700 W power limit and the 1.98 GHz boost
# clock: 132 SMs, 128 FP32 lanes each (67 TFLOP/s float32 outside the
# tensor cores, counting an FMA as 2); 3.35 TB/s of HBM3.  A draw's
# operations per pipe are counted in this run's SASS of the kernel
# (`repro_torch.kernels.sass`, whose table gives each pipe's rate).
SMS, CLOCK_HZ = 132, 1.98e9
FP32_FLOP_PER_S = SMS * 128 * 2 * CLOCK_HZ
HBM_BYTES_PER_S = 3.35e12
OP_PIPES = ("alu", "fmaheavy", "fma", "xu")
# dense tensor-core peaks of an H100 SXM at 700 W (NVIDIA's data sheet):
# bf16, and TF32, whose 3xTF32 split (three products per float32 one)
# keeps float32's accuracy
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
F32_SPLIT_FLOP_PER_S = TF32_FLOP_PER_S / 3
FLASH_F32_RTOL = 1e-5
# tests/test_torch_lm.py's bound on a bf16 prefill's logits (port vs JAX)
LM_BF16_RTOL = 5e-2
LM_ARCH = "qwen2-0.5b"
# the float32 prefill at hd 128 (the tf32 kernel's hd-128 instance):
# qwen2-1.5b at full width, its 28 layers cut to 4 for the run's time
F32_HD128_ARCH, F32_HD128_LAYERS = "qwen2-1.5b", 4
# seeds a seed-batched (``batch="vmap"``) kernel call or run holds in
# phases 3, 4 and 7
S_SEEDS = 4
# the seeds of phase 4's fig3_cifar_fused vmap run, at which phase 3
# also holds the seed-batched fused_mac at Fig. 3's hops; at the cluster
# hop its plain version computes FIG3_WINDOW symbols at each end
FIG3_VMAP_SEEDS = 2
FIG3_WINDOW = 4096
# Fig. 3's rounds in phase 4 (the paper runs 400): each is ~1 s on the
# card, and each SweepRunner run goes through both drivers
FIG3_ROUNDS = 1
# fig3 with Adam on the error-free channel, card vs CPU (phase 5): the
# gap's norm against the update's (theta - theta0), off the conv biases.
# Adam's step is lr m/sqrt(v) whatever the gradient's size, so an entry
# whose gradients are small against their rounding differences (cuDNN's
# convolutions against oneDNN's) steps differently on the two sides:
# 0.037, with 1.6 lr at most, on the H100 80GB HBM3 at 700 W.  A wrong
# update rule moves every step by a share of itself (without the bias
# corrections the first step is 3.2x smaller)
FIG3_ADAM_UPDATE_RTOL = 0.1
# Adam's step on the same inputs, card vs CPU, against each leaf's
# largest value: elementwise float32 on both sides
ADAM_STEP_RTOL = 1e-6
# users per vmapped pass in phase 7's timing of the CNN's gradients (one
# of fig3's 20 users at a time is the round's way)
GRAD_CHUNK = 5
# the LM families served at full width: (arch, layers run (None: all),
# prefill (B, positions), decode (batch, cache)), with their cuts; the
# qwen3-moe and llava depths are cut to fit the run's time and the card
# (94 layers of 128 experts are ~440 GB in bf16; llava's 60 ~68 GB), and
# zamba2-7b's 81 to 27 (4 groups of 6 Mamba2 layers, each followed by the
# shared attention block, and the tail of 3) and llava's 8 to 4 for the
# run's time since phase 10 was added (zamba2's bf16 and f32 prefills
# with their profiles took ~58 s at 81 layers); since phase 11 was added,
# for the run's time too, mamba2-780m's 48 to 24, zamba2-7b's 27 to 15 (2
# groups and the tail of 3) and qwen3-moe's 2 to 1 (its init alone took
# 9.3 s at 2 layers on the H100 80GB HBM3 at 700 W)
FAMILY_RUNS = (
    ("mamba2-780m", 24, (4, 4096), (128, 32768)),
    ("zamba2-7b", 15, (4, 4096), (2, 32768)),
    ("qwen3-moe-235b-a22b", 1, (4, 4096), (8, 32768)),
    ("seamless-m4t-medium", None, (4, 4096), (8, 32768)),
    ("llava-next-34b", 4, (4, 4096), (8, 32768)))
# the families' decode against their prefill on the card: (B, T) tokens
# streamed into an empty cache, float32
FAMILY_DECODE_CHECK = (2, 32)
# the share of a bf16 MoE layer's tokens that may route apart between
# two platforms (tests/test_torch_lm_families.py's MOE_BF16_PARTED: a
# token whose two best experts score within a rounding of each other)
MOE_BF16_PARTED = 0.03
# tests/test_flash_attn.py's shapes: (B, L, H, KV, hd)
JAX_FLASH_SHAPES = ((2, 64, 4, 2, 16), (1, 128, 8, 8, 64), (2, 96, 6, 2, 32),
                    (1, 32, 2, 1, 16), (1, 256, 2, 2, 128))
# phase 9, federated LM training: qwen2-0.5b as registered at train_4k's
# sequence, its global batch of 256 cut to C x M users of B_USER rows
# (the local-SGD run's users hold 2 x B_USER: tau = I = 2 microbatches)
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_C, TRAIN_M, TRAIN_B_USER = 2, 2, 2
# the structural run's rows a user, outer update and eta_local: one row
# a user since phase 11 (its four gloo ranks hold this run's first step
# as their one-card reference); AdamW again since its ZeRO-1 and FSDP
# case: AdamW's replicated state and update take ~25 GB a rank at this
# width (the params, m, v, the estimate, its negation, the new moments,
# the update, its decayed copy and the new params at 2.5 GB each), and 4
# x 25 GB is past 80 GB, so from phase 11's arrival until then the run
# used the outer "add"
STRUCT_B_USER, STRUCT_OUTER, STRUCT_ETA = 1, "adamw", 1.0
# the structural run's second step under `torch.profiler`: off since PR
# 25 for the run's time (the traced step and its reading took ~30 s in
# the run that measured the breakdown PERF.md keeps); on
# with ``--training``
STRUCT_TRACE = False
# the quiet radio of examples/lm_federated.py (1,024 antennas at the IS
# and the PS, a low noise floor), under which a few steps learn
TRAIN_GEOM = dict(K=1024, K_ps=1024, sigma_z2=1e-4)
# the float32 training run's depth (flash_attn_tf32 under autograd), and
# the local-SGD run's (tau = I = 2: 16 gradient passes a step, 20.2 s at
# 24 layers on the H100 80GB HBM3 at 700 W), cut for the run's time since phase 11
TRAIN_F32_LAYERS = 4
TRAIN_LOCAL_LAYERS = 2
# the attention's gradient route (the kernel forward, `attention_vjp`'s
# float32 recompute) against autograd through `flash_attention_plain`,
# of max |g|: the same function in another order at float32; at bf16
# each side rounds each gradient once from float32
ATTN_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# phase 11, W-HFL training with one process per mobile user
# (`launch.ranks`): qwen2-0.5b as registered at train_4k's sequence, each
# case (backend, world, (pod, cluster, user, model), rows a user, outer,
# eta_local, steps, layers run (None: all), placements, compute dtype,
# reference) against the one-card step on the same batch and keys.  NCCL
# at world size 1: one user, one row, AdamW, one step.  Four gloo ranks
# sharing the card, the three cases in one launch (on the H100 80GB
# HBM3 at 700 W the ranks' start took ~45 s a launch): the replicated
# state with the outer "add", its depth cut to 2 layers for the run's
# time when the ZeRO-1 case came (its 24 layers' step took 27–45 s
# there), against its own one-card run;
# ZeRO-1 and FSDP with AdamW at (1, 2, 2, 1) against phase 9's
# structural run (C 2 x M 2, STRUCT_*), whose first step is its
# reference, bit for bit; tensor parallelism at (1, 1, 2, 2) (2 users,
# "model" 2) with AdamW at float32 compute (the tf32 flash kernel on a
# rank's 7 heads) against the one-card step of 2 users, within
# TP_BOUNDS.  At bf16 compute (its card run is in PERF.md) it met the
# bound written for it (5e-2 of the largest of each kind) on the
# parameters (4.0e-3), m (4.4e-2) and the metrics (2.0e-3) but not on
# v (6.7e-2), on an H100 80GB HBM3 at 700 W: bf16's own rounding spread
# at this width (on the CPU, at reduced width, a bf16 step's gradient
# lies 2.1e-2 of max |g| from the float32 one's on one device and on
# "model" 2 alike), so a bf16 run cannot tell a fault in the split from
# bf16's noise.  Tensor parallelism at "model" 4 on (1, 1, 1, 4) (one
# user), AdamW at float32 compute, within TP_BOUNDS of the one-card step
# of one user: qwen2-0.5b's 14 heads do not divide, so with
# ``seq_shard_attn`` the "q_seq" route (each rank 1,024 of the 4,096
# rows, the flash kernels with a query offset past the first rank) and
# without it the replicated attention, whose one-card reference is the
# "q_seq" case's (the knob changes nothing on one card); qwen2-1.5b's 12
# heads split (3 a rank) beside its 2 KV heads replicated, at Q15_LAYERS
# of its 28 layers for the run's time.  For the run's time too since
# those came (phase 11 took 245 s alone with them, on the H100 80GB HBM3
# at 700 W), the NCCL case and the "model" 2 one run TP_LAYERS of
# qwen2-0.5b's 24 layers, the "model" 4 ones Q_SEQ_LAYERS.  Each case:
# (backend, world, (pod, cluster, user, model), rows a user, outer,
# eta_local, steps, layers run (None: all), placements, compute dtype,
# reference ("own", "phase 9", or the index of the earlier case whose
# one-card run it shares), arch, config overrides, route)
Q15_LAYERS, TP_LAYERS, Q_SEQ_LAYERS = 8, 8, 12
RANKS_CASES = (
    ("nccl", 1, (1, 1, 1, 1), 1, "adamw", 1.0, 1, TP_LAYERS, {}, "bfloat16",
     "own", TRAIN_ARCH, {}, None),
    ("gloo", 4, (1, TRAIN_C, TRAIN_M, 1), 1, "add", 5e-3, 1, 2, {},
     "bfloat16", "own", TRAIN_ARCH, {}, None),
    ("gloo", 4, (1, TRAIN_C, TRAIN_M, 1), STRUCT_B_USER, STRUCT_OUTER,
     STRUCT_ETA, 1, None, {"zero1": True, "fsdp": True}, "bfloat16",
     "phase 9", TRAIN_ARCH, {}, None),
    ("gloo", 4, (1, 1, 2, 2), 1, "adamw", 1.0, 1, TP_LAYERS, {}, "float32",
     "own", TRAIN_ARCH, {}, "heads split"),
    ("gloo", 4, (1, 1, 1, 4), 1, "adamw", 1.0, 1, Q_SEQ_LAYERS, {},
     "float32", "own", TRAIN_ARCH, {"seq_shard_attn": True}, "q_seq"),
    ("gloo", 4, (1, 1, 1, 4), 1, "adamw", 1.0, 1, Q_SEQ_LAYERS, {},
     "float32", 4, TRAIN_ARCH, {}, "replicated attention"),
    ("gloo", 4, (1, 1, 1, 4), 1, "adamw", 1.0, 1, Q15_LAYERS, {},
     "float32", "own", "qwen2-1.5b", {}, "KV heads replicated"),
)
# the tensor-parallel ranks against the one-card step at float32 compute
# (written before its first card run): each kind's largest gap (the
# parameters, AdamW's m and v) over the largest value of that kind, and
# the loss's and edge power's relative gaps.  The split products add
# their partial sums in another order, ~1e-6 relative at float32 (on the
# CPU, tests/test_torch_tp.py: layers within 1e-5 of the largest); an
# entry whose gradient is that rounding's size may step the other way
# under AdamW, by twice its rate (4e-3 of max |theta| = 1)
TP_BOUNDS = {"params": 1e-2, "m": 1e-2, "v": 1e-2, "metrics": 1e-4}
# phase 12, the sharded W-HFL sweep with one process per shard
# (`ShardedSweepRunner(ranks=...)`, `launch.ranks.sweep_worker`), each
# case bit for bit the one-process sharded run on the card: fig2_iid
# faithful/fused at the paper's sizes, 2 rounds, 2 seeds, on 2x2 (M 5
# padded to 6), four gloo ranks sharing the card, both combines x both
# drivers in one launch; scale_u256 on 2x4 u_sharded, eight gloo ranks,
# both drivers in one launch; scale_u256 on 1x1 under NCCL at world size
# 1 through the sweep CLI, both drivers
SWEEP_RANKS_FIG2 = (("gathered", "stepwise"), ("gathered", "chunked"),
                    ("u_sharded", "stepwise"), ("u_sharded", "chunked"))
# phase 10, sliding-window attention.  (label, (B, L, H, KV, hd), W,
# causal): each kernel with a window against its plain version, in both
# dtypes: qwen2-0.5b's prefill shape both ways, the reduced model's (hd
# 32) and hd 16 at W 100 (below the 128-key tile, not a multiple of 16),
# zamba2-7b's hd 112 and qwen2-1.5b's hd 128 at W 1,024; W 1 (each row
# keeps its own key alone); 128-row tiles that straddle two heads, a
# ragged L and every other instance at small windows
WINDOW_CASES = (
    (f"{LM_ARCH} B4 L4096", (4, 4096, 14, 2, 64), 1024, True),
    (f"{LM_ARCH} B4 L4096 bidirectional", (4, 4096, 14, 2, 64), 1024, False),
    (f"{LM_ARCH} reduced B4 L4096", (4, 4096, 4, 2, 32), 100, True),
    ("hd 16 B4 L4096", (4, 4096, 4, 2, 16), 100, True),
    ("zamba2-7b B4 L4096", (4, 4096, 32, 32, 112), 1024, True),
    ("qwen2-1.5b B1 L4096", (1, 4096, 12, 2, 128), 1024, True),
    (f"{LM_ARCH} B4 L4096 W1", (4, 4096, 14, 2, 64), 1, True),
    ("L200 bidirectional W1 (fold straddles tiles)", (2, 200, 14, 2, 64), 1,
     False),
    ("L200 (fold straddles tiles)", (2, 200, 14, 2, 64), 100, True),
    ("hd 128 L1000 bidirectional", (1, 1000, 12, 2, 128), 37, False),
    ("hd 32 L1000 bidirectional", (1, 1000, 4, 2, 32), 100, False),
    ("hd 112 L77", (1, 77, 8, 2, 112), 50, True),
    ("hd 16 L1000 bidirectional W1", (1, 1000, 4, 2, 16), 1, False))
# the cases timed, each in both dtypes
WINDOW_TIMED = {(case[0], dtype) for case in WINDOW_CASES[:5]
                for dtype in (torch.bfloat16, torch.float32)}
# (shape, causal): a window of L, L + 1 and 2^30 keys against no window,
# bit for bit, in both dtypes
WINDOW_WIDE = (((4, 4096, 14, 2, 64), True), ((4, 4096, 14, 2, 64), False),
               ((2, 200, 14, 2, 64), True), ((1, 1000, 12, 2, 128), False),
               ((1, 77, 8, 2, 112), True), ((1, 1000, 4, 2, 16), False))
# the reduced configs' window card vs CPU: below their 64 positions and
# the encoder's 16 frames
WINDOW_REDUCED = 12
# the flash kernels' query offset: a rank's block of rows under
# sequence-parallel attention ("q_seq"), qwen2-0.5b's train_4k sequence
# of 4,096 positions over "model" 4: 1,024 rows (14 heads over 2 KV
# heads, hd 64) against all 4,096 keys, causal.  (q_offset, window): the
# first and the last rank's rows, and the last's with a window of
# 1,024; each in both dtypes against the plain version and the same
# rows of the whole call, and timed
OFFSET_SHAPE, OFFSET_KEYS = (1, 1024, 14, 2, 64), 4096
OFFSET_CASES = ((0, None), (3072, None), (3072, 1024))
# each phase-11 rank's flash call at float32, timed alone (kernel
# only): (label, (B, L, H, KV, hd), keys, q_offset); under "q_seq" the
# four ranks' rows, whose causal work grows 1 : 3 : 5 : 7
RANK_FLASH = tuple(
    (f"q_seq rank {r}", OFFSET_SHAPE, OFFSET_KEYS, 1024 * r)
    for r in range(4)) + (
    ("replicated attention", (1, 4096, 14, 2, 64), 4096, 0),
    ("qwen2-1.5b KV heads replicated", (1, 4096, 3, 1, 128), 4096, 0))
# long_500k decode steps a run (the first writes the ring's last slot)
LONG_STEPS = 4
# the training steps card vs CPU (reduced qwen2-0.5b, float32 compute,
# TF32 off; outer "add", so every entry is held): the loss and edge
# power to TOL, the parameters within THETA_RTOL of max |theta|; each
# family's lm_loss to TOL and its gradient within TOL of max |g|


# the kill-and-resume check's subprocess: fig2_iid fused at the paper's
# sizes, 5 rounds, 2 seeds, through one driver and seed mode with a checkpoint
# directory and a fault plan or a resume; it writes the final carry
# (`state_doc`), the metrics and the checkpoint seconds
RESUME_SNIPPET = """
import json, sys
sys.path.insert(0, "src")
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
from repro_torch.ft import FaultPlan
from repro_torch.sim import get_scenario, sweep
a = json.loads(sys.argv[1])
sc = get_scenario("fig2_iid").replace(total_IT=5, ota_mode="faithful",
                                      ota_backend="fused")
res = sweep.SweepRunner(
    [sc], seeds=2, device="cuda", keep_state=True, driver=a["driver"],
    batch=a["batch"], checkpoint=a["ckpt"], resume=a.get("resume", False),
    faults=FaultPlan.parse(a["inject"]) if "inject" in a else None).run()
info = res[0].exec_info
json.dump({"state": sweep.state_doc(res)["scenarios"][0]["state"],
           "metrics": sweep.sweep_to_json(res)["scenarios"][0]["metrics"],
           "resumed_from": info["resumed_from"],
           "ckpt_save_seconds": info["ckpt_save_seconds"],
           "ckpt_load_seconds": info["ckpt_load_seconds"]},
          open(a["out"], "w"))
"""


# the CPU side of the card-vs-CPU checks (phases 4 and 5): one
# SweepRunner run of a scenario, in a process of its own.  A CPU run sums
# with one intra-op thread (`repro_torch.device.pinned_cpu_threads`), so
# these runs go side by side, CPU_WORKERS at a time, started before
# phase 4 and read where they are compared; each writes its metrics,
# telemetry and final state
CPU_RUN_SNIPPET = """
import json, sys
sys.path.insert(0, "src")
import torch
from repro_torch.exec import ShardedSweepRunner
from repro_torch.sim import SweepRunner
from repro_torch.sim.scenario import Scenario
a = json.loads(sys.argv[1])
kw = dict(seeds=a["seeds"], device="cpu", keep_state=True)
sc = [Scenario(**a["scenario"])]
res = (ShardedSweepRunner(sc, mesh=a["mesh"], combine="u_sharded", **kw)
       if a["mesh"] else SweepRunner(sc, batch="map", **kw)).run()[0]
torch.save({k: getattr(res, k) for k in (
    "seeds", "rounds", "acc", "loss", "edge_power", "is_power",
    "final_state", "telemetry")}, a["out"])
"""
CPU_WORKERS = 6


T_START = time.perf_counter()


def log(obj) -> None:
    """One line of the run's log; a phase's record carries the seconds
    since the run started."""
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T_START, 1)}
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def counted(run):
    """`run()` with every kernel wrapper's launch count set to 0 just
    before it; the counts just after."""
    from repro_torch.kernels import LAUNCH_COUNTERS

    for fn, attr in LAUNCH_COUNTERS.values():
        setattr(fn, attr, 0)
    out = run()
    return out, {name: getattr(fn, attr)
                 for name, (fn, attr) in LAUNCH_COUNTERS.items()}


def check_launches(label, launches, want, ok=True, totals=None):
    """Exit unless the main path `label` launched each kernel exactly
    `want` times (0 where unnamed) and its output is `ok`; add its
    launches to `totals` (the kernels line's counts) where given."""
    want = {name: want.get(name, 0) for name in KERNELS}
    log({"phase": "main_path_launches", "run": label,
         "kernel_launches": launches, "expected_launches": want,
         "finite": ok})
    if launches != want or not ok:
        raise SystemExit(f"main path {label}: launches {launches} "
                         f"(want {want}), finite {ok}")
    if totals is not None:
        for name, n in launches.items():
            totals[name] += n


def _draws_bound(draws: int, nbytes: int, cycles: dict):
    """Least time on this card for `draws` counter-PRNG draws and
    `nbytes` moved, in ms: the larger of the draws' operations on their
    busiest pipe (`cycles`: SM clocks per draw by pipe, from the
    kernel's SASS) and the bytes over HBM's rate.  Also the time the
    same instructions take to issue at one per scheduler and clock."""
    t_ops = draws * max(cycles[p] for p in OP_PIPES) / (SMS * CLOCK_HZ)
    t_issue = draws * cycles["issue"] / (SMS * CLOCK_HZ)
    t_bytes = nbytes / HBM_BYTES_PER_S
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return 1e3 * max(t_ops, t_bytes), bound_by, 1e3 * max(t_issue, t_bytes)


def fused_mac_bound_ms(B: int, U: int, K: int, N: int, cycles: dict):
    """Least time for one fused_mac call.  Draws: B*U*K*N channel +
    B*K*N noise; bytes: t (2 x U*N), amp and w (2 x B*U) read once, y
    (2 x B*N) written once, all float32."""
    return _draws_bound(B * U * K * N + B * K * N,
                        4 * (2 * U * N + 2 * B * U + 2 * B * N), cycles)


def partials_bound_ms(B: int, U: int, K: int, N: int, G: int,
                      cycles: dict):
    """Least time for one fused_mac_partials call: B*U*K*N channel draws
    (no noise); bytes: t (2 x U*N), amp and w (2 x B*U) read once, the
    four partial sums (4 x B*G*K*N) written once, all float32."""
    return _draws_bound(B * U * K * N,
                        4 * (2 * U * N + 2 * B * U + 4 * B * G * K * N),
                        cycles)


def reduce_bound_ms(B: int, G: int, K: int, N: int, cycles: dict):
    """Least time for one fused_partials_reduce call: B*K*N noise draws;
    bytes: the four partial sums (4 x B*G*K*N) read once, y (2 x B*N)
    written once, all float32."""
    return _draws_bound(B * K * N, 4 * (4 * B * G * K * N + 2 * B * N),
                        cycles)


def ota_combine_bound_ms(B: int, U: int, K: int, N: int):
    """Least time for one ota_combine call on this card: the larger of
    its bytes over HBM's rate and its float32 operations over the FP32
    peak.  Bytes: h (8 x B*U*K*N), t (8 x U*N), z (8 x B*K*N) and w
    (4 x B*U) read once, y (8 x B*N) written once.  Operations: 12 per h
    element (r += h t and mf += w h, as 6 FMAs) and 8 per (b, k, n)
    (conj(mf) r, as 4 FMAs)."""
    t_bytes = (8 * B * U * K * N + 8 * U * N + 8 * B * K * N + 4 * B * U
               + 8 * B * N) / HBM_BYTES_PER_S
    t_ops = (12 * B * U * K * N + 8 * B * K * N) / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def flash_bound_ms(B: int, L: int, S: int, H: int, KV: int, hd: int,
                   causal: bool, itemsize: int, rate: float | None = None,
                   window: int | None = None, q_offset: int = 0):
    """Least time for one flash attention call on this card: the larger
    of its operations at `rate` FLOP/s and its bytes over HBM's rate.
    Operations: 4 * hd per kept (query, key) pair (q.k and p.v, a
    multiply-add counted as 2) for each of B * H query rows of a
    position; kept pairs: `kept_pairs`, with the sliding `window` and
    the rows' first position `q_offset`.
    `rate` None takes the fastest rate that keeps the inputs' accuracy:
    the dense bf16 tensor-core peak for bf16 (itemsize 2), the 3xTF32
    rate for float32 (TF32 alone breaks the float32 gate).  Bytes: q
    and o (B*L*H*hd each) and k and v (B*S*KV*hd each), once."""
    pairs = kept_pairs(L, S, causal, window, q_offset)
    rate = rate or (BF16_FLOP_PER_S if itemsize == 2
                    else F32_SPLIT_FLOP_PER_S)
    t_ops = 4 * hd * B * H * pairs / rate
    t_bytes = itemsize * (2 * B * L * H * hd + 2 * B * S * KV * hd) / (
        HBM_BYTES_PER_S)
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                        else "bytes")


def kept_pairs(L: int, S: int, causal: bool, window: int | None = None,
               q_offset: int = 0) -> int:
    """The (query, key) pairs one head of a flash call keeps: at position
    l (q_offset .. q_offset + L - 1) the keys j < S with j <= l when
    causal and |l - j| < window with a sliding window (causal at S = L:
    W (W + 1) / 2 + (L - W) W)."""
    pos = q_offset + np.arange(L, dtype=np.int64)
    lo = np.zeros_like(pos) if window is None else np.maximum(
        0, pos - window + 1)
    hi = np.full_like(pos, S - 1)
    if causal:
        hi = np.minimum(hi, pos)
    if window is not None:
        hi = np.minimum(hi, pos + window - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def exp_floor_ms(B: int, L: int, S: int, H: int, causal: bool,
                 window: int | None = None, q_offset: int = 0) -> float:
    """The exponentials' floor of one flash call on this card: one exp2
    per kept pair on the MUFU pipe, at its rate per clock per SM in
    `sass.RATES`.  For bf16 at hd 16 and 32 it lies above
    `flash_bound_ms`, which counts only the products and the bytes."""
    from repro_torch.kernels import sass

    return 1e3 * B * H * kept_pairs(L, S, causal, window, q_offset) / (
        sass.RATES["xu"] * SMS * CLOCK_HZ)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in bf16 ULPs between two bf16 tensors."""
    def ordered(x):
        w = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(w < 0, -(w & 0x7FFF), w)
    return int((ordered(a) - ordered(b)).abs().max())


def bf16_close(got: torch.Tensor, want: torch.Tensor, rtol: float) -> bool:
    """Two bf16 tensors, each rounded once from a float32 result, whose
    float32 results lie within `rtol` of max |want|: every pair within
    that gap plus one bf16 ULP of the larger magnitude.  (A strict 1-ULP
    rule fails near zero, where the float32 gap spans many ULPs.)"""
    big = torch.maximum(got.abs(), want.abs()).contiguous()
    ulp = (big.view(torch.int16) + 1).view(torch.bfloat16).float() - (
        big.float())
    gap = (got.float() - want.float()).abs()
    return bool((gap <= rtol * want.float().abs().max() + ulp).all())


def flash_inputs(B, L, H, KV, hd, dtype, seed, dev):
    """Random q [B, L, H, hd], k and v [B, L, KV, hd] on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(*shape, generator=g, device=dev).to(dtype)
            for shape in ((B, L, H, hd), (B, L, KV, hd), (B, L, KV, hd))]


# The trace helpers are the port's (`repro_torch.kernels.trace_probe`),
# shared with the card tests: `device_trace` starts each trace with the
# card idle for TRACE_PAUSE_S, `lead_in` runs TRACE_LEAD_IN spin kernels
# (a trace can lose the device records of its first kernels: 23 of 24
# flash records in each of 4 traces of seamless-m4t-medium's prefill on
# the H100 80GB HBM3 at 700.00 W), which `device_ops` leaves out, and
# `traced_drives` ends each drive's trace with `lead_out`'s spins; a
# chunked drive's launches are counted from its graphs (`count_drives`:
# each graph's kernel nodes at its capture times its replays), since a
# trace can lose a long replay's device records (`trace_probe
# --replays`), and its trace must see no more.


def device_ops(prof) -> list:
    """(name, ms) of every device op a trace holds (kernels, copies,
    sets; no annotations, no `lead_in` spins), read from kineto's
    records, which read far faster than `prof.events()` for a trace of
    ~40k ops."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e6) for e in raw_events(prof)
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation() and SPIN_KERNEL not in e.name()]


def lm_profile(fn, warmed=False) -> dict:
    """`fn()` (one serving step, ending in a synchronize) warm (run once
    first unless `warmed`), timed on the host clock, then under
    `torch.profiler`: device ms, busy share, each flash record's share
    (its kernel and any pre-pass its entry point launches, whose time is
    also given alone) and the device ops of one call."""
    if not warmed:
        fn()
    t0 = time.perf_counter()
    fn()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with device_trace() as prof:
        lead_in()
        fn()
    ops = device_ops(prof)
    if not ops:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    by_name = defaultdict(lambda: [0.0, 0])
    for name, ms in ops:
        by_name[name][0] += ms
        by_name[name][1] += 1
    device_ms = sum(ms for ms, _ in by_name.values())
    flash = {}
    for name in FLASH_RECORDS.values():
        # a record's time holds the pre-pass its entry point launches
        pre = sum(t for k, (t, _) in by_name.items()
                  if any(fn in k for fn in FLASH_PREPASS.get(name, ())))
        ms = pre + sum(t for k, (t, _) in by_name.items()
                       if KERNELS[name][1] in k)
        flash.update({f"{name}_ms": ms, f"{name}_share": ms / device_ms,
                      f"{name}_records": sum(
                          n for k, (_, n) in by_name.items()
                          if KERNELS[name][1] in k)})
        if name in FLASH_PREPASS:
            flash[f"{name}_prepass_ms"] = pre
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms, **flash,
            "device_ops_per_call": len(ops),
            "top": [{"op": k[:72], "ms": ms, "calls": n}
                    for k, (ms, n) in top]}


def time_ms(fn, reps, warm=True):
    """Mean CUDA-event time of `reps` back-to-back calls of `fn()`,
    after one warm call unless `warm` is False."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kern, plain, k_reps, p_reps, warm_plain=True):
    """plain, kernel, kernel, plain, within one process; a plain version
    timed in one cold call (p_reps 1, not warmed; 20-25 s at the largest
    shapes) only before the kernel."""
    p1 = time_ms(plain, p_reps, warm_plain)
    k1 = time_ms(kern, k_reps)
    k2 = time_ms(kern, k_reps)
    if p_reps == 1 and not warm_plain:
        return [k1, k2], [p1]
    return [k1, k2], [p1, time_ms(plain, p_reps, warm_plain)]


def queued_ms(fn, reps: int) -> float:
    """Mean time of `reps` calls of `fn()` enqueued behind a spin kernel
    (`torch.cuda._sleep`, ~25 ms): the host has queued every call before
    the card reaches the first, so the calls run back to back and the
    CUDA events between them time the kernels and the gaps between
    launches, free of the wrapper's host time, which bounds back-to-back
    event times once its Python takes longer than the kernel."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flash_kernels_in(prof) -> dict:
    """{record: launches} of each flash kernel a `torch.profiler` trace
    saw on the card, and {"<record> pre-pass": [launches of each
    pre-pass kernel]} for the records that have one."""
    names = [name for name, _ in device_ops(prof)]
    seen = {name: sum(KERNELS[name][1] in k for k in names)
            for name in FLASH_RECORDS.values()}
    for name, fns in FLASH_PREPASS.items():
        seen[f"{name} pre-pass"] = [sum(fn in k for k in names)
                                    for fn in fns]
    return seen


def prefill_batch(cfg, specs, dev) -> dict:
    """A batch for `specs` (`batch_specs()`'s meta tensors) on `dev`:
    random tokens in the vocabulary, and random normal patch embeddings
    or source frames in the compute dtype, from seeds."""
    from repro_torch import prng

    g = torch.Generator(device=dev).manual_seed(6)
    return {name: (prng.randint(prng.PRNGKey(2, dev), tuple(spec.shape), 0,
                                cfg.vocab).to(spec.dtype)
                   if name == "tokens" else
                   torch.randn(tuple(spec.shape), generator=g,
                               device=dev).to(spec.dtype))
            for name, spec in specs.items()}


def prefill_path(label, cfg, run_params, record, pre_shape, dev, counted,
                 expect, cut, n_flash=None):
    """One prefill of a random batch at `pre_shape` through
    `serve.build_prefill_step` at `cfg`'s compute dtype: exactly
    `n_flash` (default ``cfg.n_layers``) launches of the flash kernel
    `record` and none of the others, by the count and in the profiler,
    finite logits and greedy tokens in the vocabulary.  Returns (step,
    batch)."""
    from repro_torch.launch import serve

    step, batch_specs = serve.build_prefill_step(cfg, pre_shape,
                                                 device=dev.type)
    batch = prefill_batch(cfg, batch_specs(), dev)
    n_flash = cfg.n_layers if n_flash is None else n_flash
    want = {name: n_flash if name == record else 0
            for name in FLASH_RECORDS.values()}
    for name, fns in FLASH_PREPASS.items():
        want[f"{name} pre-pass"] = [want[name]] * len(fns)

    def run_prefill():
        with device_trace() as prof:
            lead_in()
            out = step(run_params, batch)
            torch.cuda.synchronize()
        return out, flash_kernels_in(prof)

    t0 = time.perf_counter()
    (logits, traced), launches = counted(run_prefill)
    greedy = logits.argmax(-1)
    log({"phase": "main_path", "run": label, "cut": cut,
         "shape_BL": list(batch["tokens"].shape),
         **{f"{k}_shape": list(v.shape) for k, v in batch.items()
            if k != "tokens"},
         "compute_dtype": cfg.compute_dtype,
         "seconds_cold": time.perf_counter() - t0,
         "flash_kernels_in_profiler": traced, "greedy": greedy.tolist(),
         "max_abs_logit": float(logits.abs().max())})
    seen = [traced]
    # a trace that lost device records (fewer of a kernel, none more) is
    # taken again, as the chunked drives' are (TRACE_ATTEMPTS)
    while traced != want and len(seen) < TRACE_ATTEMPTS and all(
            np.all(np.asarray(traced[k]) <= np.asarray(want[k]))
            for k in want):
        _, traced = run_prefill()
        seen.append(traced)
    if len(seen) > 1:
        log({"phase": "main_path", "run": f"{label} traced again",
             "traces": seen, "launches": launches})
    if traced != want:
        raise SystemExit(f"the profiler saw flash kernels {traced} in "
                         f"{label}, not {want} (the counters: "
                         f"{launches})")
    expect(label, launches, {record: n_flash},
           tuple(logits.shape) == (batch["tokens"].shape[0], cfg.vocab)
           and bool(torch.isfinite(logits).all())
           and bool(((greedy >= 0) & (greedy < cfg.vocab)).all()))
    return step, batch


def serve_lm(cfg, dev, card, counted, expect, pre_shape, dec_shape, cuts,
             requests=(8, 32, 16)) -> dict:
    """Phase 4's dense-LM serving path through `repro_torch.launch.serve`:
    `cfg`'s weights from a seed on `dev`; a prefill at `pre_shape` at
    `cfg`'s bf16 compute (one launch of the bf16 tensor-core flash
    kernel per layer and none of the others, by the count and in the
    profiler, finite last-position logits and greedy tokens in the
    vocabulary), then the same prefill at float32 compute (one launch
    of the float32 tensor-core kernel per layer, none of the others);
    one warm decode step against `cache_specs`' prefilled cache at
    `dec_shape` (no kernel); then `requests` = (n, prompt tokens, new
    tokens): n prompts streamed into an empty cache, then greedy tokens.
    Returns what phases 5 to 7 reuse."""
    from repro_torch import prng
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    params = lm.init_params(prng.PRNGKey(0, dev), cfg)
    torch.cuda.synchronize()
    served = serve.compute_params(params, cfg)
    log({"phase": "main_path", "run": f"{cfg.name} init", "arch": cfg.name,
         "n_layers": cfg.n_layers, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
         "vocab": cfg.vocab, "heads": cfg.n_heads,
         "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
         "compute_dtype": cfg.compute_dtype,
         "n_params": sum(t.numel() for _, t in tree_leaves(params)),
         "init_seconds": time.perf_counter() - t0})

    f32 = cfg.with_(compute_dtype="float32")
    served_f32 = serve.compute_params(params, f32)
    prefill_step, pre_batch = prefill_path(
        f"{cfg.name} prefill", cfg, served, "flash_mha_wgmma", pre_shape,
        dev, counted, expect, cuts["prefill"])
    pre_tokens = pre_batch["tokens"]
    prefill_f32_step, _ = prefill_path(
        f"{cfg.name} prefill f32", f32, served_f32, "flash_mha_tf32",
        pre_shape, dev, counted, expect, cuts["prefill"])

    serve_step, token_specs = serve.build_decode_step(cfg, dec_shape,
                                                      device=dev.type)
    specs = serve.cache_specs(cfg, dec_shape)["attn"]
    cache = {"attn": {
        "k": torch.zeros(specs["k"].shape, dtype=specs["k"].dtype,
                         device=dev),
        "v": torch.zeros(specs["v"].shape, dtype=specs["v"].dtype,
                         device=dev),
        "pos": torch.full(specs["pos"].shape, dec_shape.seq_len - 1,
                          dtype=specs["pos"].dtype, device=dev)}}
    tok = torch.zeros(tuple(token_specs().shape), dtype=torch.int32,
                      device=dev)

    def one_step():
        out = serve_step(served, cache, tok)
        torch.cuda.synchronize()
        return out

    one_step()
    t0 = time.perf_counter()
    (logits, _), launches = counted(one_step)
    log({"phase": "main_path", "run": f"{cfg.name} decode step",
         "cut": cuts["decode"], "cache_k_shape": list(specs["k"].shape),
         "cache_bytes": 2 * cache["attn"]["k"].numel()
         * cache["attn"]["k"].element_size(),
         "warm_step_ms": 1e3 * (time.perf_counter() - t0), "card": card})
    expect(f"{cfg.name} decode step", launches, {},
           bool(torch.isfinite(logits).all()))

    n, prompt_len, new_tokens = requests

    def answer():
        for t in cache["attn"].values():
            t.zero_()
        state = cache
        prompts = prng.randint(prng.PRNGKey(3, dev), (n, prompt_len), 0,
                               cfg.vocab).to(torch.int32)
        for t in range(prompt_len):
            out, state = serve_step(served, state, prompts[:, t:t + 1])
        new = []
        for _ in range(new_tokens):
            new.append(out.argmax(-1).to(torch.int32)[:, None])
            out, state = serve_step(served, state, new[-1])
        torch.cuda.synchronize()
        return out, torch.cat(new, dim=1)

    t0 = time.perf_counter()
    (logits, answers), launches = counted(answer)
    wall = time.perf_counter() - t0
    steps = prompt_len + new_tokens
    log({"phase": "main_path", "run": f"{cfg.name} {n} requests",
         "prompt_tokens": prompt_len, "new_tokens": new_tokens,
         "steps": steps, "seconds": wall,
         "tokens_per_second": n * steps / wall,
         "answers": answers[:2].tolist()})
    expect(f"{cfg.name} {n} requests", launches, {},
           bool(torch.isfinite(logits).all()) and bool(
               ((answers >= 0) & (answers < cfg.vocab)).all()))
    return {"cfg": cfg, "params": params, "served": served,
            "served_f32": served_f32, "prefill_step": prefill_step,
            "prefill_f32_step": prefill_f32_step, "pre_tokens": pre_tokens,
            "serve_step": serve_step, "dec_shape": dec_shape}


def lm_reference(cfg, params, dev, prefill_len: int, decode) -> None:
    """Phase 5 for the LM: `prefill_logits` at batch 1 and `prefill_len`
    tokens on `dev` against the CPU (the plain version) on the same
    weights copied off the card: at float32 compute (the float32
    tensor-core flash kernel, 3xTF32) within TOL of max |logit|, and at
    `cfg`'s bf16 compute (the bf16 one) within LM_BF16_RTOL; each card
    run must launch its kernel once per layer and no other; then the
    streamed decode of `decode` = (B, T) tokens against the prefill of
    the same tokens on `dev`, float32, within rtol = atol = 5e-3
    (tests/test_arch_smoke.py's bound)."""
    from repro_torch import prng
    from repro_torch.kernels import flash_mha
    from repro_torch.models import lm
    from repro_torch.tree import tree_map

    f32 = cfg.with_(compute_dtype="float32")
    toks = prng.randint(prng.PRNGKey(4, dev), (1, prefill_len), 0,
                        cfg.vocab).to(torch.int32)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    counts = lambda: {"flash_mha_wgmma": flash_mha.wgmma_launches,
                      "flash_mha_tf32": flash_mha.tf32_launches}
    for run_cfg, record, rtol in ((f32, "flash_mha_tf32", TOL),
                                  (cfg, "flash_mha_wgmma", LM_BF16_RTOL)):
        before = counts()
        on_card = lm.prefill_logits(params, {"tokens": toks}, run_cfg).cpu()
        step = {n: c - before[n] for n, c in counts().items()}
        t0 = time.perf_counter()
        on_cpu = lm.prefill_logits(cpu_params, {"tokens": toks.cpu()},
                                   run_cfg)
        gap = float((on_card - on_cpu).abs().max())
        rel = gap / float(on_cpu.abs().max())
        log({"phase": "reference", "run": f"{cfg.name} prefill_logits B1 "
             f"L{prefill_len} {run_cfg.compute_dtype}",
             "what": f"the card ({record}) vs the CPU (its plain version), "
             "the same weights", "card_launches": step, "max_abs_gap": gap,
             "max_rel_gap": rel, "rtol": rtol,
             "cpu_seconds": time.perf_counter() - t0})
        if step != {n: cfg.n_layers if n == record else 0 for n in step}:
            raise SystemExit(f"{cfg.name} {run_cfg.compute_dtype} prefill "
                             f"launched {step}, not {cfg.n_layers} of "
                             f"{record}")
        if not rel <= rtol:
            raise SystemExit(f"{cfg.name} {run_cfg.compute_dtype} prefill "
                             f"on the card disagrees with the CPU: {rel} "
                             f"of max |logit|")

    B, T = decode
    toks = prng.randint(prng.PRNGKey(5, dev), (B, T), 0,
                        cfg.vocab).to(torch.int32)
    want = lm.prefill_logits(params, {"tokens": toks}, f32)
    state = lm.init_decode_cache(f32, B, T, device=dev)
    state["attn"]["pos"].zero_()
    for t in range(T):
        got, state = lm.decode_step(params, state,
                                    {"tokens": toks[:, t:t + 1]}, f32)
    gap = float((got - want).abs().max())
    close = bool(torch.allclose(got, want, rtol=5e-3, atol=5e-3))
    log({"phase": "reference", "run": f"{cfg.name} decode vs prefill B{B} "
         f"T{T} f32", "what": "streamed decode (plain attention) vs prefill "
         "(flash_mha), both on the card", "max_abs_gap": gap,
         "max_rel_gap": gap / float(want.abs().max()),
         "allclose_5e-3": close})
    if not close:
        raise SystemExit(f"{cfg.name}: streamed decode disagrees with the "
                         f"prefill by {gap}")


def small_vs_cpu(runs, params, shape) -> None:
    """Phase 5 for the serving example's model: each of phase 4's
    prefills `runs` = [(label, cfg, step, served params, tokens)] on the
    card against the same prefill through `serve.build_prefill_step` on
    the CPU (the plain versions) on `params` copied off the card: within
    TOL of max |logit| at float32 compute, LM_BF16_RTOL at bf16."""
    from repro_torch.launch import serve
    from repro_torch.tree import tree_map

    cpu_params = tree_map(lambda t: t.cpu(), params)
    for label, cfg, step, served, tokens in runs:
        rtol = TOL if cfg.compute_dtype == "float32" else LM_BF16_RTOL
        on_card = step(served, {"tokens": tokens}).cpu()
        t0 = time.perf_counter()
        cpu_step, _ = serve.build_prefill_step(cfg, shape, device="cpu")
        on_cpu = cpu_step(serve.compute_params(cpu_params, cfg),
                          {"tokens": tokens.cpu()})
        gap = float((on_card - on_cpu).abs().max())
        rel = gap / float(on_cpu.abs().max())
        log({"phase": "reference", "run": f"{label} B{shape.global_batch} "
             f"L{shape.seq_len}", "what": "the card (tensor-core flash "
             "kernels) vs the CPU (plain versions), the same weights",
             "max_abs_gap": gap, "max_rel_gap": rel, "rtol": rtol,
             "cpu_seconds": time.perf_counter() - t0})
        if not rel <= rtol:
            raise SystemExit(f"{label} on the card disagrees with the CPU: "
                             f"{rel} of max |logit|")


def lm_profiles(run: dict, dev, card) -> None:
    """Phase 6 for the LM: one warm prefill of phase 4's batch at bf16
    and at float32 compute, and one warm decode step against a
    prefilled cache of phase 4's decode shape, each through
    `lm_profile`."""
    from repro_torch.models import lm

    cfg, served, shape = run["cfg"], run["served"], run["dec_shape"]

    def prefill_call():
        run["prefill_step"](served, {"tokens": run["pre_tokens"]})
        torch.cuda.synchronize()

    def prefill_f32_call():
        run["prefill_f32_step"](run["served_f32"],
                                {"tokens": run["pre_tokens"]})
        torch.cuda.synchronize()

    cache = lm.init_decode_cache(cfg, shape.global_batch, shape.seq_len,
                                 device=dev)
    tok = torch.zeros((shape.global_batch, 1), dtype=torch.int32, device=dev)

    def decode_call():
        run["serve_step"](served, cache, tok)
        torch.cuda.synchronize()

    B, L = run["pre_tokens"].shape
    for label, fn in ((f"{cfg.name} prefill B{B} L{L}", prefill_call),
                      (f"{cfg.name} prefill f32 B{B} L{L}",
                       prefill_f32_call),
                      (f"{cfg.name} decode step B{shape.global_batch} "
                       f"S{shape.seq_len}", decode_call)):
        log({"phase": "profile", "run": label, "card": card,
             **lm_profile(fn)})


def flash_layers(cfg) -> int:
    """The flash launches of one prefill of `cfg`: one per attention
    layer of its decoder (the hybrid's shared block once per group) and
    of its encoder."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers + (cfg.n_enc_layers if cfg.family == "encdec"
                           else 0)


@contextlib.contextmanager
def moe_trace():
    """What a prefill inside the block routes and computes: "routes",
    (top_e [G, T, K], keep [G, T*K]) of every `mlp.route` call in call
    order (one per MoE layer), and "hidden", the float32 hidden states
    [B, L, D] of the last `lm.backbone` call."""
    from repro_torch.models import lm
    from repro_torch.nn import mlp

    seen = {"routes": [], "hidden": None}
    route, backbone = mlp.route, lm.backbone

    def spy_route(*args, **kw):
        out = route(*args, **kw)
        seen["routes"].append((out["top_e"].cpu(), out["keep"].cpu()))
        return out

    def spy_backbone(*args, **kw):
        out = backbone(*args, **kw)
        seen["hidden"] = out[0].float().cpu()
        return out

    mlp.route, lm.backbone = spy_route, spy_backbone
    try:
        yield seen
    finally:
        mlp.route, lm.backbone = route, backbone


def logits_gap(label, cfg, on_card, on_cpu, rtol, traces=None) -> dict:
    """The card's logits [B, vocab] against the CPU's within `rtol` of
    max |logit|.  With `traces` (the two runs' `moe_trace`), a bf16 MoE
    run: a token whose two best experts score within a rounding of each
    other may route apart, which moves its row's logits by whole
    experts, so at most MOE_BF16_PARTED of a layer's tokens may part;
    the final hidden states of each row's leading tokens whose experts
    and drops agree in every layer (causal attention and a per-token
    combine keep them free of the parted tokens) are held within `rtol`
    of max |h|, and there must be at least one such token; and so are
    the logits of each row whose tokens all agree."""
    B = on_card.shape[0]
    gaps = (on_card - on_cpu).abs().amax(-1) / on_cpu.abs().max()
    held = torch.ones(B, dtype=torch.bool)
    parted, tokens_ok = [], True
    if traces is not None:
        card, cpu = traces
        T = cpu["hidden"].shape[1]
        clean = torch.full((B,), T)
        for (card_e, card_k), (cpu_e, cpu_k) in zip(card["routes"],
                                                    cpu["routes"]):
            diff = (card_e != cpu_e).any(-1).reshape(B, T)
            parted.append(float(diff.float().mean()))
            diff |= (card_k != cpu_k).reshape(B, T, -1).any(-1)
            clean = torch.minimum(clean, torch.where(
                diff.any(-1), diff.int().argmax(-1), T))
        held = clean == T
        tokens = torch.arange(T)[None, :] < clean[:, None]
        n_tokens = int(tokens.sum())
        hidden_gap = (float((card["hidden"] - cpu["hidden"]).abs()[tokens]
                            .max() / cpu["hidden"].abs().max())
                      if n_tokens else float("nan"))
        tokens_ok = n_tokens > 0 and hidden_gap <= rtol
    ok = (tokens_ok and bool((gaps[held] <= rtol).all())
          and all(p <= MOE_BF16_PARTED for p in parted))
    rec = {"max_rel_gap": float(gaps.max()), "rel_gap_by_row":
           gaps.tolist(), "rtol": rtol}
    if traces is not None:
        rec.update(moe_parted_share_by_layer=parted,
                   rows_held=int(held.sum()), tokens_held=n_tokens,
                   tokens_held_by_row=clean.tolist(),
                   hidden_rel_gap=hidden_gap)
    if not ok:
        raise SystemExit(f"{label}: the card disagrees with the CPU: "
                         f"{rec}")
    return rec


def family_vs_cpu(arch, dev) -> None:
    """Phase 8's card-vs-CPU check of one family at its reduced config:
    `prefill_logits` (B 2, 64 positions) on the card against the CPU on
    the same weights, at float32 compute within TOL of max |logit| and
    at the config's bf16 within LM_BF16_RTOL (the dense family's bounds;
    a bf16 MoE as `logits_gap` holds it), then one `decode_step` from
    the prefill's empty cache, float32, within TOL."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(arch).reduced()
    params = lm.init_params(prng.PRNGKey(0, dev), cfg)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    g = torch.Generator().manual_seed(8)
    n_tok = 64 - (cfg.n_patches if cfg.family == "vlm" else 0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, n_tok), generator=g,
                                     dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(2, cfg.n_patches, cfg.d_model,
                                            generator=g)
    if cfg.family == "encdec":
        batch["src_frames"] = torch.randn(2, cfg.enc_src_frames,
                                          cfg.d_model, generator=g)
    for run_cfg, rtol in ((cfg.with_(compute_dtype="float32"), TOL),
                          (cfg, LM_BF16_RTOL)):
        b = {k: v if k == "tokens" else v.to(run_cfg.cdt())
             for k, v in batch.items()}
        with moe_trace() as card_trace:
            on_card = lm.prefill_logits(
                params, {k: v.to(dev) for k, v in b.items()}, run_cfg).cpu()
        with moe_trace() as cpu_trace:
            on_cpu = lm.prefill_logits(cpu_params, b, run_cfg)
        bf16_moe = cfg.family == "moe" and run_cfg.compute_dtype != "float32"
        rec = logits_gap(f"{arch} reduced {run_cfg.compute_dtype}", cfg,
                         on_card, on_cpu, rtol,
                         (card_trace, cpu_trace) if bf16_moe else None)
        log({"phase": "families", "run": f"{arch} reduced prefill B2 L64 "
             f"{run_cfg.compute_dtype}", "what": "the card (flash kernels) "
             "vs the CPU (plain versions), the same weights", **rec})
    f32 = cfg.with_(compute_dtype="float32")
    steps = {}
    for where, p in ((dev.type, params), ("cpu", cpu_params)):
        cache = lm.init_decode_cache(f32, 2, 16, device=where)
        for _, t in tree_leaves(cache):
            t.zero_()
        steps[where], _ = lm.decode_step(
            p, cache, {"tokens": batch["tokens"][:, :1].to(where)}, f32)
    rec = logits_gap(f"{arch} reduced decode step", cfg,
                     steps[dev.type].cpu(), steps["cpu"], TOL)
    log({"phase": "families", "run": f"{arch} reduced decode step B2 f32",
         "what": "the card vs the CPU, the same weights", **rec})


def decode_vs_prefill(cfg, params, dev) -> None:
    """FAMILY_DECODE_CHECK's (B, T) tokens streamed through an empty
    cache on the card against their prefill on the card, float32,
    within rtol = atol = 5e-3 (tests/test_arch_smoke.py's bound): a MoE
    at a capacity that drops no token (c_f = E / K), a vlm with no
    patches, an encdec with its encoded frames in the cache."""
    from repro_torch import prng
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    f32 = cfg.with_(compute_dtype="float32")
    if cfg.family == "moe":
        f32 = f32.with_(capacity_factor=cfg.n_experts / cfg.top_k)
    B, T = FAMILY_DECODE_CHECK
    batch = {"tokens": prng.randint(prng.PRNGKey(5, dev), (B, T), 0,
                                    cfg.vocab).to(torch.int32)}
    g = torch.Generator(device=dev).manual_seed(9)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(B, 0, cfg.d_model, device=dev)
    if cfg.family == "encdec":
        batch["src_frames"] = torch.randn(B, 64, cfg.d_model, generator=g,
                                          device=dev)
    want = lm.prefill_logits(params, batch, f32)
    cache = lm.init_decode_cache(f32, B, T, device=dev)
    for _, t in tree_leaves(cache):
        t.zero_()
    if cfg.family == "encdec":
        cache["enc_out"] = lm._encode(params, batch, f32)
    for t in range(T):
        got, cache = lm.decode_step(
            params, cache, {"tokens": batch["tokens"][:, t:t + 1]}, f32)
    gap = float((got - want).abs().max())
    close = bool(torch.allclose(got, want, rtol=5e-3, atol=5e-3))
    log({"phase": "families", "run": f"{cfg.name} decode vs prefill B{B} "
         f"T{T} f32", "what": "streamed decode vs prefill, both on the "
         "card", "max_abs_gap": gap,
         "max_rel_gap": gap / float(want.abs().max()),
         "allclose_5e-3": close})
    if not close:
        raise SystemExit(f"{cfg.name}: streamed decode disagrees with the "
                         f"prefill by {gap}")


def serve_family(arch, n_layers, pre, dec, dev, card, counted,
                 expect) -> None:
    """Phase 8's serving path for one family at full width: weights from
    `lm.init_params` at seed 0 (depth cut to `n_layers` where given); a
    prefill of `pre` = (B, positions) through `serve.build_prefill_step`
    at bf16 (and, for the hybrid, float32) compute, its flash launches
    by the count and in the profiler (`flash_layers`), finite logits;
    its time (`lm_profile`); one `build_decode_step` step at `dec` =
    (batch, cache) against `init_decode_cache`'s prefilled cache (no
    kernel of ours: decode attends in plain torch), finite, and its
    time; then `decode_vs_prefill`."""
    from repro_torch import prng
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    full = get_config(arch)
    cfg = full if n_layers is None else full.with_(n_layers=n_layers)
    depth = ("" if n_layers is None
             else f"; depth {full.n_layers} -> {n_layers} layers")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(prng.PRNGKey(0, dev), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    served = serve.compute_params(params, cfg)
    leaves = [t for _, t in tree_leaves(params)]
    log({"phase": "families", "run": f"{arch} init", "arch": arch,
         "family": cfg.family, "n_layers": cfg.n_layers,
         "d_model": cfg.d_model, "vocab": cfg.vocab,
         "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
         "head_dim": cfg.head_dim, "param_dtype": cfg.param_dtype,
         "n_params": sum(t.numel() for t in leaves),
         "param_bytes": sum(t.numel() * t.element_size() for t in leaves),
         "served_bytes": sum(t.numel() * t.element_size()
                             for _, t in tree_leaves(served)),
         "init_seconds": init_s,
         "device_allocated_bytes": torch.cuda.memory_allocated()})
    B, positions = pre
    n_patches = cfg.n_patches if cfg.family == "vlm" else 0
    pre_shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"],
                                    global_batch=B,
                                    seq_len=positions - n_patches)
    cut = (f"prefill_32k: batch 32 -> {B}, length 32768 -> {positions}"
           + (f" ({n_patches} patches + {positions - n_patches} tokens)"
              if n_patches else "") + depth)
    runs = [(cfg, served, "flash_mha_wgmma", "")]
    if cfg.family == "hybrid":
        f32 = cfg.with_(compute_dtype="float32")
        runs.append((f32, serve.compute_params(params, f32),
                     "flash_mha_tf32", " f32"))
    for run_cfg, run_params, record, suffix in runs:
        label = f"{arch} prefill{suffix}"
        step, batch = prefill_path(label, run_cfg, run_params, record,
                                   pre_shape, dev, counted, expect, cut,
                                   n_flash=flash_layers(cfg))

        def prefill_call():
            step(run_params, batch)
            torch.cuda.synchronize()

        log({"phase": "profile", "run": f"{label} B{B} L{positions}",
             "cut": cut, "flash_launches": flash_layers(cfg),
             "card": card, **lm_profile(prefill_call, warmed=True)})
        del step, batch, run_params
    del runs
    Bd, S = dec
    dec_shape = dataclasses.replace(INPUT_SHAPES["decode_32k"],
                                    global_batch=Bd, seq_len=S)
    dec_cut = (f"decode_32k: batch 128 -> {Bd}, cache {S}" if Bd != 128
               else f"decode_32k: batch 128, cache {S}") + depth
    serve_step, token_specs = serve.build_decode_step(cfg, dec_shape,
                                                      device=dev.type)
    cache = lm.init_decode_cache(cfg, Bd, S, window=serve.decode_window(
        cfg, dec_shape), device=dev)
    tok = torch.zeros(tuple(token_specs().shape), dtype=torch.int32,
                      device=dev)

    def one_step():
        out = serve_step(served, cache, tok)
        torch.cuda.synchronize()
        return out

    (logits, _), launches = counted(one_step)
    expect(f"{arch} decode step", launches, {},
           bool(torch.isfinite(logits).all()))
    log({"phase": "profile", "run": f"{arch} decode step B{Bd} S{S}",
         "cut": dec_cut, "cache_bytes": sum(
             t.numel() * t.element_size() for _, t in tree_leaves(cache)),
         "card": card, **lm_profile(one_step, warmed=True)})
    del cache, served, logits
    decode_vs_prefill(cfg, params, dev)
    log({"phase": "families", "run": f"{arch} memory",
         "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    del params, leaves
    torch.cuda.empty_cache()


def attention_grad_check(dev, card) -> dict:
    """Phase 9's attention gradient at the training path's shape (B 2,
    L 4096, 14 heads over 2 at hd 64, causal), bf16 and float32:
    `flash_attention_autograd` (the routed kernel forward, `attention_vjp`
    backward) against autograd through `flash_attention_plain` on the
    same inputs within ATTN_GRAD_TOL of max |g|, and the backward's time
    against its kernel forward's (CUDA events).  Returns {dtype name:
    record}."""
    from repro_torch.kernels import (attention_vjp, flash_attention,
                                     flash_attention_autograd,
                                     flash_attention_plain)

    B, L, H, KV, hd = TRAIN_B_USER, 4096, 14, 2, 64
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = [t.requires_grad_() for t in flash_inputs(
            B, L, H, KV, hd, dtype, 31, dev)]
        g = torch.Generator(device=dev).manual_seed(32)
        do = torch.randn(B, L, H * hd, generator=g, device=dev).to(dtype)
        got = torch.autograd.grad(flash_attention_autograd(
            q, k, v, causal=True, q_block=512), (q, k, v), do)
        want = torch.autograd.grad(flash_attention_plain(
            q, k, v, causal=True, q_block=512, kv_block=1024), (q, k, v), do)
        errs = [float((a.float() - b.float()).abs().max())
                / float(b.float().abs().max()) for a, b in zip(got, want)]
        del got, want
        fwd = lambda: flash_attention(q.detach(), k.detach(), v.detach(),
                                      causal=True)
        bwd = lambda: attention_vjp(q.detach(), k.detach(), v.detach(), do,
                                    causal=True, q_block=512)
        times = {}
        for name, fn, reps in (("forward_ms", fwd, 10), ("vjp_ms", bwd, 3)):
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[name] = start.elapsed_time(end) / reps
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        rec = {"shape_BLHKVhd": [B, L, H, KV, hd], "dtype": name,
               "max_rel_err_dq_dk_dv": errs, "tol": ATTN_GRAD_TOL[dtype],
               **times, "vjp_over_forward": times["vjp_ms"]
               / times["forward_ms"], "card": card}
        log({"phase": "training", "run": f"attention gradient {name}",
             "what": "flash_attention_autograd vs autograd through "
             "flash_attention_plain, on the card", **rec})
        if not max(errs) <= ATTN_GRAD_TOL[dtype]:
            raise SystemExit(f"attention gradient {name}: {errs}")
        out[name] = rec
        del q, k, v, do
    return out


def train_batch(cfg, B, L, seed, dev) -> dict:
    """Random tokens and labels [B, L] in the vocabulary, from seeds."""
    from repro_torch import prng

    return {name: prng.randint(prng.PRNGKey(seed + i, dev), (B, L), 0,
                               cfg.vocab).to(torch.int32)
            for i, name in enumerate(("tokens", "labels"))}


def train_runs(step, state, batch, steps, trace=False,
               after_first=None) -> tuple:
    """`steps` train steps on one batch, each ended by a synchronize and
    timed on the host clock; with `trace`, one more step under
    `torch.profiler`; ``after_first(state, metrics)`` (untimed) after
    the first.  Returns (state, losses, edge powers, wall ms per step,
    the trace or None)."""
    from repro_torch import prng

    losses, powers, walls, prof = [], [], [], None
    for i in range(steps + int(trace)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == steps:
            with device_trace() as prof:
                lead_in()
                state, m = step(state, batch, prng.PRNGKey(100 + i))
                torch.cuda.synchronize()
        else:
            state, m = step(state, batch, prng.PRNGKey(100 + i))
            torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        powers.append(float(m["edge_power"]))
        if i == 0 and after_first is not None:
            after_first(state, m)
    return state, losses, powers, walls, prof


def emulation_ms_per_normal(dev) -> float:
    """Device ms per normal drawn through the `jax.random` emulation, at
    the slices the hops draw in (`nn.core.DRAW_SLICE` elements; CUDA
    events over 3 slices after one warm one)."""
    from repro_torch import prng
    from repro_torch.core.dist import draw_normal
    from repro_torch.nn.core import DRAW_SLICE

    key = prng.PRNGKey(7, dev)
    draw_normal(key, (DRAW_SLICE,))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(3):
        draw_normal(prng.fold_in(key, i), (DRAW_SLICE,))
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * DRAW_SLICE)


def range_device_ms(prof, label) -> tuple:
    """(device ms, device ops) of the kernels, copies and sets that the
    host ops inside a trace's `label` ranges (`record_function`) launched,
    each linked to its host op by kineto's correlation id (the host runs
    ahead of the card, so the device ops' own times say nothing of the
    range)."""
    import bisect

    from torch.autograd import DeviceType

    events = raw_events(prof)
    spans = sorted((e.start_ns(), e.end_ns()) for e in events
                   if e.name() == label and e.device_type() == DeviceType.CPU)
    starts = [lo for lo, _ in spans]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= spans[i][1]

    ids = {e.correlation_id() for e in events
           if e.device_type() == DeviceType.CPU and e.name() != label
           and inside(e.start_ns())}
    ops = [e.duration_ns() / 1e6 for e in events
           if e.device_type() == DeviceType.CUDA
           and not e.is_user_annotation()
           and e.linked_correlation_id() in ids]
    return sum(ops), len(ops)


def step_profile(prof, wall_ms, n_normals, ms_per_normal) -> dict:
    """A traced train step's device ms, busy share (device ms over the
    step's untraced wall ms), device ops, each flash record's ms and
    launches, and the threefry emulation's share: as the trace measures
    it, the device ops launched inside ``dist.draw_normal``
    (`range_device_ms`); as an estimate, its `n_normals` draws at
    `emulation_ms_per_normal`; and the int64 kernels' device time in the
    trace (the emulation's integer half)."""
    ops = device_ops(prof)
    device_ms = sum(ms for _, ms in ops)
    int64_ms = sum(ms for name, ms in ops if "<long" in name)
    draw_ms, draw_ops = range_device_ms(prof, "dist.draw_normal")
    rec = {"device_ms": device_ms, "wall_ms": wall_ms,
           "device_busy_share": device_ms / wall_ms,
           "device_ops": len(ops), "normals_drawn": n_normals,
           "emulation_traced_ms": draw_ms,
           "emulation_traced_ops": draw_ops,
           "emulation_traced_share": draw_ms / device_ms,
           "emulation_estimate_ms": n_normals * ms_per_normal,
           "emulation_estimate_share": n_normals * ms_per_normal
           / device_ms,
           "int64_kernels_ms": int64_ms,
           "int64_kernels_share": int64_ms / device_ms}
    for name in FLASH_RECORDS.values():
        hits = [ms for k, ms in ops if KERNELS[name][1] in k]
        rec[f"{name}_ms"], rec[f"{name}_launches"] = sum(hits), len(hits)
    by_name = defaultdict(float)
    for name, ms in ops:
        by_name[name] += ms
    rec["top"] = [{"op": k[:72], "ms": ms} for k, ms in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:6]]
    return rec


def train_phase(dev, card, expect, reference=None,
                trace=STRUCT_TRACE) -> None:
    """Phase 9: federated LM training (`repro_torch.launch.train`) at
    qwen2-0.5b's full width and train_4k's sequence, bf16 compute and
    float32 parameters, remat on (the config's): the structural step
    (tau = I = 1, equivalent channel, STRUCT_* rows and outer update)
    for 2 steps on one batch (with `trace`, the second under
    `torch.profiler`), its final state and metrics written to
    `reference` where given (phase 11's); local SGD (tau = I = 2, outer "add", depth cut to
    TRAIN_LOCAL_LAYERS), 1 step; the fused step (grad_accum 2, AdamW),
    1 step; one fused step at float32 compute, depth cut to
    TRAIN_F32_LAYERS.
    Each: finite loss and edge power, wall ms a step, peak memory, and
    its flash launches against the code's count (layers x 2 with remat
    per micro-forward: the forward, and its recompute in the backward);
    the structural loss must fall.  Then the attention gradient on the
    card (`attention_grad_check`) and card vs CPU (`train_vs_cpu`)."""
    from repro_torch import prng
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.core.dist import OTADistConfig, uniform_geom
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(TRAIN_ARCH)
    n_users = TRAIN_C * TRAIN_M
    mesh = {"data": n_users}
    geom = uniform_geom(C=TRAIN_C, M=TRAIN_M, **TRAIN_GEOM)
    L = INPUT_SHAPES["train_4k"].seq_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params0 = lm_init(cfg, dev)
    n_params = sum(t.numel() for _, t in tree_leaves(params0))
    ms_per_normal = emulation_ms_per_normal(dev)
    # (label, build, b_user, TrainConfig, steps, micro-forwards a step,
    # trace one more step, layers run (None: all))
    runs = (
        ("structural", train.build_train_step, STRUCT_B_USER,
         train.TrainConfig(tau=1, I=1, users_per_cluster=TRAIN_M,
                           eta_local=STRUCT_ETA, outer=STRUCT_OUTER,
                           outer_lr=2e-3, geom=geom, ota=OTADistConfig()),
         2 - int(trace), n_users, trace, None),
        ("local SGD", train.build_train_step, 2 * TRAIN_B_USER,
         train.TrainConfig(tau=2, I=2, users_per_cluster=TRAIN_M,
                           eta_local=5e-3, outer="add", geom=geom,
                           ota=OTADistConfig()), 1, 4 * n_users, False,
         TRAIN_LOCAL_LAYERS),
        ("fused", train.build_fused_train_step, TRAIN_B_USER,
         train.TrainConfig(tau=1, I=1, users_per_cluster=TRAIN_M,
                           eta_local=1.0, outer="adamw", outer_lr=2e-3,
                           grad_accum=2, geom=geom,
                           ota=OTADistConfig(tx_power_proxy=1e-4)), 1, 2,
         False, None))
    for label, build, b_user, tcfg, steps, micro, trace, layers in runs:
        B = n_users * b_user
        shape = dataclasses.replace(INPUT_SHAPES["train_4k"],
                                    global_batch=B)
        run_cfg = cfg if layers is None else cfg.with_(n_layers=layers)
        per_fwd = run_cfg.n_layers * (2 if cfg.remat else 1)
        # a depth cut runs the first `layers` layers of params0's stacks
        p0 = (params0 if layers is None else
              {**params0, "layers": tree_map(lambda t: t[:layers],
                                             params0["layers"])})
        step, _ = build(run_cfg, shape, mesh, tcfg, device=dev.type)
        state = {"params": tree_map(torch.clone, p0),
                 "opt": (adamw(tcfg.outer_lr).init(p0)
                         if tcfg.outer == "adamw" else {}),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        batch = train_batch(cfg, B, L, 40, dev)
        saved = {}

        def save_reference(state, m):
            """The structural run's state after its first step and that
            step's metrics: phase 11's reference for the four gloo
            ranks (one step since phase 12 was added)."""
            from repro_torch.launch import ranks

            t0 = time.perf_counter()
            ranks.save_reference(reference, state, [m])
            saved["seconds"] = time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats()
        (state, losses, powers, walls, prof), launches = counted(
            lambda: train_runs(step, state, batch, steps, trace,
                               save_reference if label == "structural"
                               and reference else None))
        ok = bool(np.all(np.isfinite(losses + powers)))
        if label == "structural":
            ok = ok and losses[-1] < losses[0]
        expect(f"{TRAIN_ARCH} train {label}", launches,
               {"flash_mha_wgmma": (steps + int(trace)) * micro * per_fwd},
               ok)
        rec = {"phase": "training", "run": f"{TRAIN_ARCH} {label}",
               "cut": f"train_4k: global batch 256 -> {B} (C {TRAIN_C} x "
               f"M {TRAIN_M} x {b_user} rows)" + (
                   "" if layers is None else
                   f"; depth {cfg.n_layers} -> {layers} layers"),
               "seq_len": L,
               "tau": tcfg.tau, "I": tcfg.I, "outer": tcfg.outer,
               "grad_accum": tcfg.grad_accum,
               "n_params": sum(t.numel() for _, t in tree_leaves(p0)),
               "losses": losses, "edge_powers": powers, "wall_ms": walls,
               "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
               "flash_launches": launches["flash_mha_wgmma"],
               "flash_launches_per_micro_forward": per_fwd, "card": card}
        if prof is not None:
            # the structural step draws 9 normals an entry: 4 users' gain
            # jitter, 2 clusters' noise and global jitter, the PS's noise
            rec["profile"] = step_profile(prof, walls[-2], 9 * n_params,
                                          ms_per_normal)
        if saved:
            rec["reference_save_seconds"] = saved["seconds"]
        log(rec)
        del step, state, batch, prof
        gc.collect()
        torch.cuda.empty_cache()
    del params0
    gc.collect()
    torch.cuda.empty_cache()

    # float32 compute: flash_attn_tf32 under autograd, depth cut
    f32 = cfg.with_(compute_dtype="float32", n_layers=TRAIN_F32_LAYERS)
    tcfg = train.TrainConfig(tau=1, I=1, users_per_cluster=TRAIN_M,
                             eta_local=1.0, outer="adamw", outer_lr=2e-3,
                             grad_accum=2, geom=geom)
    B = n_users * TRAIN_B_USER
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=B)
    step, init_fn = train.build_fused_train_step(f32, shape, mesh, tcfg,
                                                 device=dev.type)
    state, _ = init_fn(prng.PRNGKey(0))
    batch = train_batch(f32, B, L, 40, dev)
    torch.cuda.reset_peak_memory_stats()
    (state, losses, powers, walls, _), launches = counted(
        lambda: train_runs(step, state, batch, 1))
    expect(f"{TRAIN_ARCH} train fused f32 ({TRAIN_F32_LAYERS} layers)",
           launches, {"flash_mha_tf32": 2 * TRAIN_F32_LAYERS * 2},
           bool(np.all(np.isfinite(losses + powers))))
    log({"phase": "training", "run": f"{TRAIN_ARCH} fused f32",
         "cut": f"train_4k: global batch 256 -> {B}; depth "
         f"{cfg.n_layers} -> {TRAIN_F32_LAYERS} layers", "losses": losses,
         "edge_powers": powers, "wall_ms": walls,
         "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
         "flash_launches": launches["flash_mha_tf32"], "card": card})
    del step, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    attention_grad_check(dev, card)
    train_vs_cpu(dev)


def lm_init(cfg, dev):
    """`lm.init_params` at seed 0 on `dev`, its seconds logged."""
    from repro_torch import prng
    from repro_torch.models import lm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init_params(prng.PRNGKey(0, dev), cfg)
    torch.cuda.synchronize()
    log({"phase": "training", "run": f"{cfg.name} init",
         "init_seconds": time.perf_counter() - t0,
         "device_allocated_bytes": torch.cuda.memory_allocated()})
    return params


def train_vs_cpu(dev) -> None:
    """Phase 9's card-vs-CPU check: reduced qwen2-0.5b at float32
    compute and parameters (TF32 off on both sides), 2 structural and 2
    fused steps from one state (equivalent channel, outer "add"): losses
    and edge powers within TOL, the parameters within THETA_RTOL of max
    |theta|; then one `lm_loss` and its gradient per family (and
    arctic-480b's dense residual) at its reduced config, float32 compute
    and parameters (bf16 parameters would round each gradient to bf16 on
    each side), the loss within TOL and every leaf within TOL of max
    |g|."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.dist import OTADistConfig
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_map

    f32 = dict(compute_dtype="float32", param_dtype="float32")
    cfg = get_config(TRAIN_ARCH).reduced().with_(**f32)
    shape = InputShape("tiny", 64, 8, "train")
    params = lm.init_params(prng.PRNGKey(0), cfg)
    g = torch.Generator().manual_seed(41)
    batch = {k: torch.randint(0, cfg.vocab, (8, 64), generator=g,
                              dtype=torch.int32) for k in ("tokens",
                                                           "labels")}
    for label, build, tcfg in (
            ("structural", train.build_train_step, train.TrainConfig(
                tau=1, I=1, users_per_cluster=2, eta_local=0.05,
                outer="add", ota=OTADistConfig())),
            ("fused", train.build_fused_train_step, train.TrainConfig(
                tau=1, I=1, users_per_cluster=2, eta_local=0.05,
                outer="add", grad_accum=2,
                ota=OTADistConfig(tx_power_proxy=1e-4)))):
        out = {}
        for where in (dev.type, "cpu"):
            step, _ = build(cfg, shape, {"data": 4}, tcfg, device=where)
            state = {"params": tree_map(lambda t: t.clone().to(where),
                                        params), "opt": {},
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=where)}
            b = {k: v.to(where) for k, v in batch.items()}
            ms = []
            for i in range(2):
                state, m = step(state, b, prng.PRNGKey(50 + i))
                ms.append({k: float(v) for k, v in m.items()})
            out[where] = (ms, dict(tree_leaves(state["params"])))
        (card_m, card_p), (cpu_m, cpu_p) = out[dev.type], out["cpu"]
        metric_gap = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in
                         zip(card_m, cpu_m) for k in b)
        theta = max(float(t.abs().max()) for t in cpu_p.values())
        theta_gap = max(float((card_p[k].cpu() - t).abs().max())
                        for k, t in cpu_p.items()) / theta
        ok = metric_gap <= TOL and theta_gap <= THETA_RTOL
        log({"phase": "training", "run": f"reduced {TRAIN_ARCH} {label} "
             "2 steps, card vs CPU", "metrics_card": card_m,
             "metrics_cpu": cpu_m, "max_rel_metric_gap": metric_gap,
             "theta_gap_rel_max": theta_gap, "ok": ok})
        if not ok:
            raise SystemExit(f"training {label}: card vs CPU apart by "
                             f"{metric_gap} (metrics), {theta_gap} (theta)")
    for arch in [run[0] for run in FAMILY_RUNS] + [TRAIN_ARCH,
                                                    "arctic-480b"]:
        cfg = get_config(arch).reduced().with_(**f32)
        params = lm.init_params(prng.PRNGKey(0), cfg)
        g = torch.Generator().manual_seed(42)
        n_tok = 64
        b = {k: torch.randint(0, cfg.vocab, (2, n_tok), generator=g,
                              dtype=torch.int32) for k in ("tokens",
                                                           "labels")}
        if cfg.family == "vlm":
            b["patch_embeds"] = torch.randn(2, cfg.n_patches, cfg.d_model,
                                            generator=g)
        if cfg.family == "encdec":
            b["src_frames"] = torch.randn(2, cfg.enc_src_frames,
                                          cfg.d_model, generator=g)
        res = {}
        for where in (dev.type, "cpu"):
            p = tree_map(lambda t: t.to(where).requires_grad_(), params)
            loss, _ = lm.lm_loss(p, {k: v.to(where) for k, v in b.items()},
                                 cfg, loss_block=32)
            grads = torch.autograd.grad(loss, [t for _, t in
                                               tree_leaves(p)])
            res[where] = (float(loss.detach()), [t.cpu() for t in grads])
        (l_card, g_card), (l_cpu, g_cpu) = res[dev.type], res["cpu"]
        g_max = max(float(t.abs().max()) for t in g_cpu)
        g_gap = max(float((a - b).abs().max()) for a, b in
                    zip(g_card, g_cpu)) / g_max
        loss_gap = abs(l_card - l_cpu) / abs(l_cpu)
        ok = loss_gap <= TOL and g_gap <= TOL
        log({"phase": "training", "run": f"{arch} reduced lm_loss and "
             "gradient f32, card vs CPU", "loss_card": l_card,
             "loss_cpu": l_cpu, "loss_rel_gap": loss_gap,
             "grad_gap_rel_max": g_gap, "ok": ok})
        if not ok:
            raise SystemExit(f"{arch}: lm_loss card vs CPU {loss_gap}, "
                             f"gradient {g_gap}")


def tp_gaps(vs) -> dict:
    """The tensor-parallel ranks' distance to the one-card step from
    `compare_to_reference`'s gaps: each kind's (parameters, AdamW's m
    and v) largest gap over the largest reference value among its
    unequal leaves, and the metrics' relative gaps."""
    out = {}
    for kind, prefix in (("params", "state/params/"), ("m", "state/opt/m/"),
                         ("v", "state/opt/v/"), ("metrics", "metrics/")):
        gaps = [g for name, g in vs["gaps"].items()
                if name.startswith(prefix)]
        if kind == "metrics":
            out[kind] = max((gap / max(ref, 1e-30) for gap, ref in gaps),
                            default=0.0)
        else:
            out[kind] = (max((gap for gap, _ in gaps), default=0.0)
                         / max(max((ref for _, ref in gaps), default=1.0),
                               1e-30))
    return out


def ranks_phase(card, expect, gloo_reference=None) -> None:
    """Phase 11: the structural W-HFL step with one process per mobile
    user (`launch.ranks.launch`, `train_worker`) at qwen2-0.5b's (or
    qwen2-1.5b's) full width, for each of RANKS_CASES: the one-card step
    (`{"data": C x M}`) first, its final state and metrics written to a
    file (`ranks.save_reference`) and its memory freed (a case that
    shares an earlier case's one-card run reads that one's file); then
    the ranks (the gloo cases in one launch, each case in turn), each
    building the mesh on its world, refining it, drawing its shards of
    the state (`init_fn`), cutting its own rows of the same global batch
    and running the same keys.  Each rank reports its peak device
    memory, step seconds, seconds inside collectives, collective groups
    and flash launches (layers x 2 per step: one user, one
    micro-forward; under "model" 2 on 7 of 14 heads and 1 of 2 KV heads;
    under "q_seq" on 1,024 of 4,096 rows, with a query offset past the
    first rank, counted apart), and how its shards compare with the same
    blocks of the one-card run's state and its metrics: bit for bit, or
    within TP_BOUNDS under tensor parallelism; the phase fails unless
    every rank's do.  `gloo_reference`: phase 9's structural run,
    written by `train_phase` (the ZeRO-1 case's one-card run, not run
    again here)."""
    from repro_torch import prng
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.core.dist import OTADistConfig, uniform_geom
    from repro_torch.launch import ranks, train

    L = INPUT_SHAPES["train_4k"].seq_len
    tmp = tempfile.mkdtemp(prefix="smoke-ranks-")
    cases = []
    try:
        for i, (backend, world, mesh, b_user, outer, eta, steps, layers,
                place, cdt, source, arch, over, route) in enumerate(
                    RANKS_CASES):
            cfg = get_config(arch).with_(compute_dtype=cdt, **over)
            depth = cfg.n_layers
            cfg = cfg if layers is None else cfg.with_(n_layers=layers)
            per_fwd = cfg.n_layers * (2 if cfg.remat else 1)
            flash = ("flash_mha_wgmma" if cdt == "bfloat16"
                     else "flash_mha_tf32")
            C, M = mesh[0] * mesh[1], mesh[2]
            tcfg = train.TrainConfig(
                tau=1, I=1, users_per_cluster=M, eta_local=eta, outer=outer,
                outer_lr=2e-3, ota=OTADistConfig(),
                geom=uniform_geom(C=C, M=M, **TRAIN_GEOM), **place)
            B = C * M * b_user
            shape = dataclasses.replace(INPUT_SHAPES["train_4k"],
                                        global_batch=B)
            keys = [100 + i for i in range(steps)]
            label = (f"{arch} ranks {backend} world {world} "
                     f"{'/'.join(map(str, mesh))}"
                     + "".join(f" {k}" for k in place)
                     + ("" if cdt == "bfloat16" else f" {cdt}")
                     + ("" if route in (None, "heads split")
                        else f" {route}"))
            cut = (f"train_4k: global batch 256 -> {B} (C {C} x M {M} x "
                   f"{b_user} rows)" + ("" if outer == "adamw" else
                                        "; outer add (no moments)")
                   + ("" if layers is None else
                      f"; depth {depth} -> {layers} layers"))

            def one_card():
                step, init_fn = train.build_train_step(
                    cfg, shape, {"data": C * M}, tcfg, device="cuda")
                state, _ = init_fn(prng.PRNGKey(0))
                ms, walls = [], []
                for k in keys:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = step(state, batch, prng.PRNGKey(k))
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    ms.append(m)
                return state, ms, walls

            batch = train_batch(cfg, B, L, 40, torch.device("cuda"))
            ref = os.path.join(tmp, f"reference{i}.pt")
            if source == "phase 9" and gloo_reference:
                ref = gloo_reference
                log({"phase": "ranks", "run": f"{label} one-card reference",
                     "from": "phase 9's structural run", "cut": cut})
            elif isinstance(source, int):
                ref = os.path.join(tmp, f"reference{source}.pt")
                log({"phase": "ranks", "run": f"{label} one-card reference",
                     "from": f"case {source}'s one-card run (the same "
                     "function on one card)", "cut": cut})
            else:
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                (state, ms, walls), launches = counted(one_card)
                expect(f"{label} one-card", launches,
                       {flash: steps * C * M * per_fwd},
                       all(bool(torch.isfinite(v)) for m in ms
                           for v in m.values()))
                t0 = time.perf_counter()
                if world == 1:
                    # the launcher runs a world of one in this process
                    ref = ranks.reference(state, ms)
                else:
                    ranks.save_reference(ref, state, ms)
                save_s = time.perf_counter() - t0
                log({"phase": "ranks", "run": f"{label} one-card reference",
                     "cut": cut, "mesh": {"data": C * M}, "steps": steps,
                     "metrics": [{k: float(v) for k, v in m.items()}
                                 for m in ms], "step_seconds": walls,
                     "peak_allocated_bytes":
                         torch.cuda.max_memory_allocated(),
                     "reference_save_seconds": save_s, "card": card})
                del state, ms
                gc.collect()
                torch.cuda.empty_cache()
            cases.append(dict(
                label=label, cut=cut, mesh=mesh, place=place, flash=flash,
                launches=steps * per_fwd, split=mesh[3] > 1, route=route,
                spec=dict(cfg=cfg, shape=shape, tcfg=tcfg, mesh=mesh,
                          batches=[{k: v.cpu() for k, v in batch.items()}],
                          keys=keys, reference=ref)))
            del batch
            if world == 1:
                ranks_launch(card, expect, backend, world, cases)
                cases = []
        ranks_launch(card, expect, "gloo", 4, cases)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ranks_launch(card, expect, backend, world, cases) -> None:
    """One launch of `world` ranks running `cases` in turn (their
    `train_worker` specs), each rank's results checked and logged per
    case; fails unless every rank of every case matches its
    reference."""
    from repro_torch.launch import ranks

    t0 = time.perf_counter()
    res = ranks.launch(ranks.train_worker, world, backend,
                       [c["spec"] for c in cases])
    wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    bad = []
    for i, c in enumerate(cases):
        ok = True
        for r in (rank[i] for rank in res):
            vs = r["vs_reference"]
            finite = all(np.isfinite(v) for m in r["metrics"]
                         for v in m.values())
            if c["split"]:
                gaps = tp_gaps(vs)
                same = all(gaps[k] <= b for k, b in TP_BOUNDS.items())
            else:
                gaps, same = None, not vs["unequal"]
            # under "q_seq" every launch past the first rank's rows has a
            # query offset
            offsets = (c["launches"] * bool(r["coordinate"].get("model"))
                       if c["route"] == "q_seq" else 0)
            same = same and r["offset_launches"] == offsets
            ok = ok and same and finite
            log({"phase": "ranks", "run": f"{c['label']} rank {r['rank']}",
                 "backend": r["backend"], "coordinate": r["coordinate"],
                 "device": r["device"], "metrics": r["metrics"],
                 "step_seconds": r["step_seconds"],
                 "collective_seconds": r["collective_seconds"],
                 "collectives": r["collectives"],
                 "peak_allocated_bytes": r["peak_allocated_bytes"],
                 "flash_launches": r["launches"][c["flash"]],
                 "flash_offset_launches": r["offset_launches"],
                 "route": c["route"],
                 **({"within_tp_bounds": same, "tp_gaps": gaps,
                     "tp_bounds": TP_BOUNDS,
                     "unequal_leaves": len(vs["unequal"])} if c["split"]
                    else {"bitwise_equal_to_one_card": same}),
                 "vs_one_card": {"leaves": vs["leaves"],
                                 "unequal": vs["unequal"][:8],
                                 "max_abs_diff": vs["max_abs_diff"]},
                 "card": card})
            expect(f"{c['label']} rank {r['rank']}", r["launches"],
                   {c["flash"]: c["launches"]}, same and finite)
        log({"phase": "ranks", "run": c["label"], "cut": c["cut"],
             "mesh_pod_cluster_user_model": list(c["mesh"]),
             "placements": c["place"], "ok": ok, "card": card})
        if not ok:
            bad.append(c["label"])
    log({"phase": "ranks", "run": f"launch of {world} {backend} ranks",
         "cases": [c["label"] for c in cases], "launch_seconds": wall,
         "card": card})
    for path in {c["spec"]["reference"] for c in cases
                 if isinstance(c["spec"]["reference"], str)}:
        os.remove(path)
    if bad:
        raise SystemExit(f"{', '.join(bad)}: a rank differs from the "
                         "one-card step or is not finite")


def sweep_rank_launches(res, combine: str) -> dict:
    """The kernels one rank of a sharded sweep launches through the
    stepwise driver: its own tile's `fused_mac` (gathered), or its own
    tile's partial combine and its symbol slice's fold (u_sharded), I a
    round and seed, and the IS -> PS `fused_mac` a round and seed on
    every rank (replicated, as the fold is over ``cluster``); with
    ``warmup`` the first window's rounds once more."""
    warm = res.rounds[0] if res.exec_info["warmup"] else 0
    hops = (res.rounds[-1] + warm) * len(res.seeds)
    I = res.scenario.I
    if combine == "gathered":
        return {"fused_mac": hops * (I + 1)}
    return {"fused_mac": hops, "fused_mac_partials": hops * I,
            "fused_partials_reduce": hops * I}


def log_rank(label, rep, res, card, same) -> None:
    """One rank's record: its coordinate, rounds/s, seconds inside
    collectives, collectives, peak memory and launches."""
    log({"phase": "sweep_ranks", "run": f"{label} rank {rep['rank']}",
         "backend": rep["backend"], "coordinate": rep["coordinate"],
         "device": rep["device"], "driver": res.exec_info["driver"],
         "rounds_per_sec": res.rounds[-1] / res.exec_info["drive_seconds"],
         "drive_seconds": res.exec_info["drive_seconds"],
         "collective_seconds": rep["collective_seconds"],
         "collectives": rep["collectives"],
         "peak_allocated_bytes": rep["peak_allocated_bytes"],
         "peak_symbol_bytes": res.exec_info["peak_symbol_bytes"],
         "launches": rep["launches"], **same, "card": card})


def sweep_ranks_phase(card, expect, one_process=None) -> None:
    """Phase 12: the sharded W-HFL sweep with one process per shard, on
    the card.  `one_process`: the one-process sharded runs on the card
    the cases are held to, by (scenario name, mesh, combine) (phase 4's
    scale_u256 ones); the missing ones run here first.  Every rank's
    final state and metrics must equal the one-process run's bit for
    bit, and each stepwise rank must launch what its tile calls for
    (`sweep_rank_launches`); the chunked ranks replay the graphs between
    their collectives and are held bit for bit.  Each rank logs its
    rounds/s, seconds inside collectives and peak memory."""
    from repro_torch.exec import ShardedSweepRunner, parse_mesh
    from repro_torch.kernels import build
    from repro_torch.launch import ranks
    from repro_torch.sim import get_scenario, sweep
    from repro_torch.tree import tree_map

    one_process = dict(one_process or {})
    fig2 = get_scenario("fig2_iid").replace(total_IT=2, ota_mode="faithful",
                                            ota_backend="fused")
    u256 = get_scenario("scale_u256")

    def reference(sc, mesh, combine):
        key = (sc.name, mesh, combine)
        if key not in one_process:
            one_process[key] = ShardedSweepRunner(
                [sc], seeds=2, mesh=mesh, combine=combine, keep_state=True,
                device="cuda").run()[0]
        return one_process[key]

    def check(label, rep, want, stepwise: bool) -> None:
        """One rank's run against the one-process run `want`."""
        res = rep["results"][0]
        same = bitwise_runs(want, dataclasses.replace(
            res, final_state=tree_map(lambda t: t.cuda(), res.final_state)))
        ok = same["state_bitwise_equal"] and same["metrics_bitwise_equal"]
        log_rank(label, rep, res, card, same)
        if stepwise:
            expect(f"{label} rank {rep['rank']}", rep["launches"],
                   sweep_rank_launches(res, res.exec_info["combine"]), ok)
        if not ok:
            raise SystemExit(f"{label}: rank {rep['rank']} differs from "
                             f"the one-process sharded run: {same}")

    build.load_all(["fused_mac", "ota_combine"])
    # (a) fig2_iid on 2x2, four gloo ranks, both combines and drivers; (b)
    # scale_u256 on 2x4 u_sharded, eight gloo ranks, both drivers: one
    # launch each
    for sc, mesh, cases in (
            (fig2, "2x2", SWEEP_RANKS_FIG2),
            (u256, "2x4", (("u_sharded", "stepwise"),
                           ("u_sharded", "chunked")))):
        want = {c: reference(sc, mesh, c) for c, _ in cases}
        shape = parse_mesh(mesh)
        # warmed, so a rank's rounds/s holds no first-call costs
        specs = [dict(scenarios=[sc], seeds=[0, 1], keep_state=True,
                      mesh=shape, combine=c, driver=d, warmup=True,
                      device="cuda") for c, d in cases]
        t0 = time.perf_counter()
        reps = ranks.launch(ranks.sweep_worker, shape[0] * shape[1],
                            "gloo", specs)
        wall = time.perf_counter() - t0
        for i, (c, d) in enumerate(cases):
            for rank_reps in reps:
                check(f"{sc.name} {ota_label(sc)} {mesh} {c} {d} gloo",
                      rank_reps[i], want[c], d == "stepwise")
        log({"phase": "sweep_ranks", "run": f"{sc.name} {mesh} gloo",
             "cases": [list(case) for case in cases],
             "world": shape[0] * shape[1], "launch_seconds": wall,
             "card": card})

    # (c) scale_u256 on 1x1 under NCCL at world size 1, through the sweep
    # CLI, both drivers (each in this process)
    want = reference(u256, "1x1", "u_sharded")
    label = "scale_u256 1x1 u_sharded nccl"
    runs = []
    run = ShardedSweepRunner.run

    def keep(self):
        out = run(self)
        runs.append((self.driver, self.rank_reports))
        return out

    tmp = tempfile.mkdtemp(prefix="smoke-sweep-ranks-")
    try:
        state_out = os.path.join(tmp, "state.json")
        argv = ["--scenarios", "scale_u256", "--seeds", "2", "--exec",
                "sharded", "--mesh", "1x1", "--combine", "u_sharded",
                "--ranks", "nccl", "--driver", "stepwise,chunked",
                "--state-out", state_out]
        ShardedSweepRunner.run = keep
        t0 = time.perf_counter()
        try:
            doc = sweep.main(argv)
        finally:
            ShardedSweepRunner.run = run
        wall = time.perf_counter() - t0
        states = json.load(open(state_out))["scenarios"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want_state = sweep.state_doc([want])["scenarios"][0]["state"]
    want_metrics = {"acc": want.acc, "loss": want.loss,
                    "edge_power": want.edge_power, "is_power": want.is_power}
    for rec, st, (driver, reps) in zip(doc["scenarios"], states, runs):
        same = {"state_bitwise_equal": st["state"] == want_state,
                "metrics_bitwise_equal": rec["metrics"] == want_metrics}
        (rep,) = reps
        log_rank(f"{label} {driver}", rep, rep["results"][0], card, same)
        if driver == "stepwise":
            expect(f"{label} {driver} rank 0", rep["launches"],
                   sweep_rank_launches(rep["results"][0], "u_sharded"),
                   all(same.values()))
        if not all(same.values()):
            raise SystemExit(f"{label} {driver}: differs from the "
                             f"one-process sharded run: {same}")
    log({"phase": "sweep_ranks", "run": label, "argv": argv, "world": 1,
         "exec": doc["scenarios"][0]["exec"], "cli_seconds": wall,
         "card": card})


def flash_times(label, shape, dtype, reps, dev, card, in_turns, time_ms,
                flash_pair, check_flash, queued=False) -> tuple:
    """Phase 7 for flash attention at `shape` = (B, L, H, KV, hd),
    causal, in `dtype`: the kernel `flash_route` picks and its plain
    version in turns (`reps` = kernel and plain repetitions), the kernel
    held to the last plain output, with `queued` also its time queued
    behind a spin (`queued_ms`, twice); the library's
    `scaled_dot_product_attention` on the [B, H, L, hd] layout (a
    yardstick, never on the path, held to the backend it chooses, which
    is logged with the kernels the profiler saw; for float32 on k and v
    expanded to H heads), `flash_bound_ms` (for float32 also at the
    TF32 peak) and `exp_floor_ms` (logged only: the record holds
    measured times and the bound).  Returns (the kernel's record, its
    times)."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_attention, flash_attention_plain

    B, L, H, KV, hd = shape
    q, k, v = flash_inputs(B, L, H, KV, hd, dtype, 90, dev)
    kept = {}

    def plain():
        kept["o"] = flash_attention_plain(q, k, v)

    k_reps, p_reps = reps
    ks, ps = in_turns(lambda: flash_attention(q, k, v), plain, k_reps,
                      p_reps, warm_plain=p_reps > 1)
    queued = ({"kernel_queued_ms": [
        queued_ms(lambda: flash_attention(q, k, v), k_reps)
        for _ in range(2)]} if queued else {})
    name, o1, o2 = flash_pair(q, k, v, True)
    check_flash(name, f"{label} (timed)", shape, dtype, True, o1, o2,
                kept["o"])
    qs, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    # float32: k and v expanded to H heads beforehand, since enable_gqa
    # sends float32 to the MATH backend; EFFICIENT can then run (3xTF32
    # on the tensor cores)
    gqa = dtype == torch.bfloat16
    if not gqa:
        kt, vt = (x.repeat_interleave(H // KV, dim=1) for x in (kt, vt))
    backend = SDPBackend(torch._fused_sdp_choice(
        qs, kt, vt, None, 0.0, True, scale=None, enable_gqa=gqa))

    def sdpa():
        return F.scaled_dot_product_attention(qs, kt, vt, is_causal=True,
                                              enable_gqa=gqa)

    # only the backend SDPA chose for these inputs may run
    with sdpa_kernel(backend):
        lib = [time_ms(sdpa, k_reps), time_ms(sdpa, k_reps)]
        with device_trace() as prof:
            o_lib = sdpa()
            torch.cuda.synchronize()
    kernels = sorted({e.name[:80] for e in prof.events()
                      if e.device_type == DeviceType.CUDA})
    bound, bound_by = flash_bound_ms(B, L, L, H, KV, hd, True,
                                     q.element_size())
    extra = {} if gqa else {"bound_tf32_peak_ms": flash_bound_ms(
        B, L, L, H, KV, hd, True, 4, rate=TF32_FLOP_PER_S)[0]}
    ms = sum(ks) / 2
    log({"phase": "times", "kernel": name, "shape": label,
         "shape_BLHKVhd": list(shape), "dtype": str(dtype).split(".")[-1],
         "kernel_ms": ks, "plain_ms": ps, "library_ms": lib,
         "library_call": "scaled_dot_product_attention(is_causal=True"
                         + (", enable_gqa=True) on [B, H, L, hd]" if gqa else
                            ") on [B, H, L, hd], k and v expanded to H "
                            "heads beforehand"),
         "library_backend": backend.name, "library_kernels": kernels,
         "library_vs_kernel_max_abs_gap": float(
             (o_lib.transpose(1, 2).reshape(o1.shape).float()
              - o1.float()).abs().max()),
         "kernel_tflops": 4 * hd * B * H * L * (L + 1) / 2 / ms / 1e9,
         **queued, "bound_ms": bound, "bound_by": bound_by, **extra,
         "exp_floor_ms": exp_floor_ms(B, L, L, H, True), "card": card})
    return name, dict(ms=ms, plain_ms=sum(ps) / len(ps), bound_ms=bound,
                      bound_by=bound_by, library_ms=sum(lib) / 2, **queued,
                      dtype=str(dtype).split(".")[-1], shape=list(shape))


def window_sdpa(q, k, v, causal: bool, window: int | None,
                q_offset: int = 0):
    """The library's yardstick for a windowed flash call, or one on a
    block of rows at positions q_offset + l: `sdpa()`,
    `scaled_dot_product_attention` with an explicit boolean mask [L, S]
    (the window's and the causal one at those positions) on the [B, H,
    L, hd] layout, k and v expanded to H heads (no GQA mode with a
    mask), and the backend it chose for these inputs."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qs = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).repeat_interleave(H // KV, dim=1)
              .contiguous() for x in (k, v))
    d = (q_offset + torch.arange(L, device=q.device)[:, None]
         - torch.arange(S, device=q.device)[None, :])
    keep = (d.abs() < window) if window is not None else torch.ones_like(
        d, dtype=torch.bool)
    if causal:
        keep &= d >= 0
    backend = SDPBackend(torch._fused_sdp_choice(qs, kt, vt, keep, 0.0,
                                                 False, scale=None,
                                                 enable_gqa=False))

    def sdpa():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=keep)

    return sdpa, backend


def window_kernels(dev, card, record_err, timings) -> None:
    """Phase 10a: each flash kernel with a sliding window against its
    plain version (`flash_attention_plain(window=W)`) on the same
    inputs, in both dtypes, at WINDOW_CASES: two launches give the same
    bits, float32 within FLASH_F32_RTOL of max |o|, bf16 within that
    plus one bf16 ULP (`bf16_close`), each counted on the kernel
    `flash_route` names and on `flash_mha.window_launches`; a window of
    at least L keys gives the unwindowed launch's bits (WINDOW_WIDE);
    the WINDOW_TIMED cases timed by CUDA events in turns with the plain
    version, beside the library's masked SDPA (`window_sdpa`) and
    `flash_bound_ms` with the window.  `record_err(name, err, rel)`
    takes each check's gap; `timings[name, label]` each timed case."""
    from repro_torch.kernels import (LAUNCH_COUNTERS, flash_attention,
                                     flash_attention_plain, flash_mha,
                                     flash_route)

    def counts():
        return ({name: getattr(fn, attr) for name, (fn, attr)
                 in LAUNCH_COUNTERS.items() if name in FLASH_RECORDS.values()},
                flash_mha.window_launches)

    def pair(q, k, v, causal, window):
        name = FLASH_RECORDS[flash_route(q)]
        before, wb = counts()
        o1 = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        o2 = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        after, wa = counts()
        want = {**before, name: before[name] + 2}
        if after != want or wa - wb != (2 if window else 0):
            raise SystemExit(f"flash_attention(window={window}) launched "
                             f"{after} from {before}, windowed {wa - wb}")
        return name, o1, o2

    for i, (label, shape, window, causal) in enumerate(WINDOW_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            B, L, H, KV, hd = shape
            q, k, v = flash_inputs(B, L, H, KV, hd, dtype, 140 + i, dev)
            name, o1, o2 = pair(q, k, v, causal, window)
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            torch.cuda.synchronize()
            same = torch.equal(o1, o2)
            err = float((o1.float() - want.float()).abs().max())
            rel = err / float(want.float().abs().max())
            bf16 = dtype == torch.bfloat16
            ok = (bf16_close(o1, want, FLASH_F32_RTOL) if bf16
                  else rel <= FLASH_F32_RTOL)
            record_err(name, err, rel)
            log({"phase": "window", "kernel": name, "case": label,
                 "shape_BLHKVhd": list(shape), "window": window,
                 "causal": causal, "dtype": str(dtype).split(".")[-1],
                 "max_abs_err": err, "max_rel_err": rel,
                 "max_bf16_ulps": bf16_ulps(o1, want) if bf16 else None,
                 "bitwise_repeat": same})
            if not (same and ok and math.isfinite(rel)):
                raise SystemExit(f"{name} with window {window} disagrees "
                                 f"with its plain version at {label}: rel "
                                 f"{rel}, repeat {same}")
            if (label, dtype) in WINDOW_TIMED:
                timings[name, f"{label} W{window}"] = window_times(
                    name, label, q, k, v, causal, window, want, card)
            del q, k, v, o1, o2, want
    for shape, causal in WINDOW_WIDE:
        for dtype in (torch.bfloat16, torch.float32):
            B, L, H, KV, hd = shape
            q, k, v = flash_inputs(B, L, H, KV, hd, dtype, 150, dev)
            name, o1, _ = pair(q, k, v, causal, None)
            same = {w: torch.equal(o1, pair(q, k, v, causal, w)[1])
                    for w in (L, L + 1, 1 << 30)}
            log({"phase": "window", "kernel": name, "case": "W >= L is "
                 "the unwindowed launch, bit for bit",
                 "shape_BLHKVhd": list(shape), "causal": causal,
                 "dtype": str(dtype).split(".")[-1],
                 "bitwise_equal_by_window": same})
            if not all(same.values()):
                raise SystemExit(f"{name}: a window >= L changed bits at "
                                 f"{shape}: {same}")
            del q, k, v, o1


def window_times(name, label, q, k, v, causal, window, want, card,
                 q_offset: int = 0) -> dict:
    """One windowed flash case (or one on a block of rows from position
    `q_offset`) timed: the kernel (CUDA events, 2 x 10 calls, back to
    back and, with an offset, queued behind a spin) and its plain
    version (2 x 2) in turns, the library's masked SDPA (`window_sdpa`,
    held to the kernel's output within 1e-2 of max |o|: it rounds p to
    the inputs' dtype), `flash_bound_ms` and `exp_floor_ms` with the
    window and the offset."""
    from torch.nn.attention import sdpa_kernel

    from repro_torch.kernels import flash_attention, flash_attention_plain

    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ks, ps = in_turns(lambda: flash_attention(q, k, v, **kw),
                      lambda: flash_attention_plain(q, k, v, **kw), 10, 2)
    # a block of a "q_seq" rank's rows: a call short enough that the
    # wrapper's host time may bound back-to-back launches
    queued = ({"kernel_queued_ms": [
        queued_ms(lambda: flash_attention(q, k, v, **kw), 10)
        for _ in range(2)]} if S != L else {})
    sdpa, backend = window_sdpa(q, k, v, causal, window, q_offset)
    with sdpa_kernel(backend):
        lib = [time_ms(sdpa, 10), time_ms(sdpa, 10)]
        o_lib = sdpa().transpose(1, 2).reshape(want.shape)
    lib_gap = float((o_lib.float() - want.float()).abs().max()
                    / want.float().abs().max())
    if not lib_gap <= 1e-2:
        raise SystemExit(f"the masked SDPA yardstick is {lib_gap} from the "
                         f"plain version at {label}")
    bound, bound_by = flash_bound_ms(B, L, S, H, KV, hd, causal,
                                     q.element_size(), window=window,
                                     q_offset=q_offset)
    pairs = kept_pairs(L, S, causal, window, q_offset)
    ms = sum(ks) / 2
    dtype = str(q.dtype).split(".")[-1]
    log({"phase": "window_times" if not q_offset and S == L
         else "offset_times", "kernel": name, "shape": label,
         "shape_BLHKVhd": [B, L, H, KV, hd], "keys": S, "window": window,
         "q_offset": q_offset, "causal": causal, "dtype": dtype,
         "kernel_ms": ks, **queued, "plain_ms": ps,
         "library_ms": lib, "library_call": "scaled_dot_product_attention("
         "attn_mask=the boolean mask of the window and the rows' "
         "positions) on [B, H, L, hd], k and v expanded to H heads",
         "library_backend": backend.name,
         "library_vs_plain_rel_gap": lib_gap,
         "kept_pairs_per_head": pairs,
         "kernel_tflops": 4 * hd * B * H * pairs / ms / 1e9,
         "bound_ms": bound, "bound_by": bound_by,
         "unwindowed_bound_ms": flash_bound_ms(
             B, L, S, H, KV, hd, causal, q.element_size(),
             q_offset=q_offset)[0],
         "exp_floor_ms": exp_floor_ms(B, L, S, H, causal, window, q_offset),
         "card": card})
    return dict(ms=ms, plain_ms=sum(ps) / len(ps), bound_ms=bound,
                bound_by=bound_by, library_ms=sum(lib) / 2, **queued,
                dtype=dtype, shape=[B, L, H, KV, hd], keys=S, window=window,
                q_offset=q_offset, causal=causal)


def window_prefill(dev, card, counted, expect) -> None:
    """Phase 10b: qwen2-0.5b as registered with ``sliding_window`` set to
    its ``long_context_window`` (8,192), prefilled at bf16 at
    prefill_32k's full shape (32 x 32,768 positions) through
    `serve.build_prefill_step`: exactly 24 launches of the bf16 kernel,
    each with the window (`flash_mha.window_launches`), and none of the
    others, by the count and in the profiler, finite logits (the cold
    call, `prefill_path`); then a warm call timed and profiled
    (`lm_profile`: wall ms, device ms, busy share), and the peak of
    device memory over both."""
    from repro_torch import prng
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.kernels import flash_mha
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config(LM_ARCH)
    cfg = cfg.with_(sliding_window=cfg.long_context_window)
    shape = INPUT_SHAPES["prefill_32k"]
    params = lm.init_params(prng.PRNGKey(0, dev), cfg)
    served = serve.compute_params(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    label = f"{cfg.name} prefill_32k W{cfg.sliding_window}"
    flash_mha.window_launches = 0
    step, batch = prefill_path(
        label, cfg, served, "flash_mha_wgmma", shape, dev, counted, expect,
        "none: qwen2-0.5b as registered, prefill_32k's 32 x 32,768")
    windowed = flash_mha.window_launches
    if windowed != cfg.n_layers:
        raise SystemExit(f"{label}: {windowed} windowed flash launches, "
                         f"not {cfg.n_layers}")

    def call():
        step(served, batch)
        torch.cuda.synchronize()

    rec = lm_profile(call, warmed=True)
    B, L = batch["tokens"].shape
    log({"phase": "window_prefill", "run": label, "shape_BL": [B, L],
         "window": cfg.sliding_window, "windowed_launches": windowed,
         **rec, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
         "flash_bound_ms_per_layer": flash_bound_ms(
             B, L, L, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, True, 2,
             window=cfg.sliding_window)[0],
         "unwindowed_flash_bound_ms_per_layer": flash_bound_ms(
             B, L, L, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, True,
             2)[0], "card": card})
    del served, batch, step
    gc.collect()
    torch.cuda.empty_cache()


def long_decode(dev, card, counted, expect) -> None:
    """Phase 10c: long_500k (batch 1, a cache of 524,288 positions)
    through `serve.build_decode_step`: qwen2-0.5b as registered, whose
    attention caches are rings of ``long_context_window`` = 8,192 slots
    (`serve.decode_window`) with pos at 524,287, so the first step
    writes slot 8,191 and the next ones wrap to slots 0, 1, 2; and
    mamba2-780m, whose O(1) state holds no positions.  LONG_STEPS steps
    each from zero caches: no kernel of ours, finite logits, pos
    advanced by one a step, the ring written exactly at those slots in
    every layer; the warm step's ms, and the peak of device memory."""
    from repro_torch import prng
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_map

    shape = INPUT_SHAPES["long_500k"]
    for arch in (LM_ARCH, "mamba2-780m"):
        cfg = get_config(arch)
        params = lm.init_params(prng.PRNGKey(0, dev), cfg)
        served = serve.compute_params(params, cfg)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step, token_specs = serve.build_decode_step(cfg, shape,
                                                    device=dev.type)
        specs = serve.cache_specs(cfg, shape)
        cache = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                               device=dev), specs)
        if "attn" in cache:
            cache["attn"]["pos"].fill_(shape.seq_len - 1)
        tok = torch.zeros(tuple(token_specs().shape), dtype=torch.int32,
                          device=dev)

        def steps():
            nonlocal cache
            ms, outs = [], []
            for t in range(LONG_STEPS):
                t0 = time.perf_counter()
                logits, cache = step(served, cache, tok + t)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                outs.append(logits)
            return ms, outs

        (ms, outs), launches = counted(steps)
        ok = all(bool(torch.isfinite(o).all()) and tuple(o.shape) == (
            shape.global_batch, cfg.vocab) for o in outs)
        rec = {}
        window = serve.decode_window(cfg, shape)
        if "attn" in cache:
            S = cache["attn"]["k"].shape[2]
            slots = [(shape.seq_len - 1 + t) % S for t in range(LONG_STEPS)]
            written = (cache["attn"]["k"].abs().sum(dim=(0, 1, 3, 4)) > 0
                       ).nonzero().flatten().tolist()
            pos = cache["attn"]["pos"]
            ok = ok and S == window and sorted(written) == sorted(slots) \
                and bool((pos == shape.seq_len - 1 + LONG_STEPS).all())
            rec = {"ring_slots": S, "slots_written": slots,
                   "slots_found_written": written,
                   "pos_after": int(pos.max())}
        log({"phase": "long_decode", "run": f"{arch} long_500k decode",
             "batch": shape.global_batch, "seq_len": shape.seq_len,
             "window": window, "steps": LONG_STEPS, "step_ms": ms,
             "warm_step_ms": min(ms[1:]), **rec,
             "cache_bytes": sum(t.numel() * t.element_size()
                                for _, t in tree_leaves(cache)),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "card": card})
        expect(f"{arch} long_500k decode", launches, {}, ok)
        del served, cache
        gc.collect()
        torch.cuda.empty_cache()


def window_vs_cpu(dev, card) -> None:
    """Phase 10d: reduced dense, encdec and hybrid configs with
    ``sliding_window`` = WINDOW_REDUCED (below the 64 positions and the
    encoder's 16 frames), float32 compute and parameters, card (the
    tf32 kernel with the window) vs CPU (its plain version) on the same
    weights: `prefill_logits` within TOL of max |logit|; `lm_loss` within
    TOL and its gradient within TOL of max |g| (phase 9's bounds); then
    the windowed attention gradient at (2, 4096, 14, 2, 64), W 1024,
    causal: `flash_attention_autograd` against autograd through
    `flash_attention_plain` within ATTN_GRAD_TOL of max |g| in both
    dtypes, and `attention_vjp`'s time (over 4,096 / 512 query blocks of
    at most 512 + 1,023 keys) against the windowed kernel forward's and
    the unwindowed backward's."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels import (attention_vjp, flash_attention,
                                     flash_attention_autograd,
                                     flash_attention_plain)
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_map

    f32 = dict(compute_dtype="float32", param_dtype="float32",
               sliding_window=WINDOW_REDUCED)
    for arch in ("qwen2-0.5b", "seamless-m4t-medium", "zamba2-7b"):
        cfg = get_config(arch).reduced().with_(**f32)
        params = lm.init_params(prng.PRNGKey(0), cfg)
        g = torch.Generator().manual_seed(43)
        b = {k: torch.randint(0, cfg.vocab, (2, 64), generator=g,
                              dtype=torch.int32) for k in ("tokens",
                                                           "labels")}
        if cfg.family == "encdec":
            b["src_frames"] = torch.randn(2, cfg.enc_src_frames,
                                          cfg.d_model, generator=g)
        res = {}
        for where in (dev.type, "cpu"):
            p = tree_map(lambda t: t.to(where).requires_grad_(), params)
            bw = {k: v.to(where) for k, v in b.items()}
            with torch.no_grad():
                logits = lm.prefill_logits(p, bw, cfg).cpu()
            loss, _ = lm.lm_loss(p, bw, cfg, loss_block=32)
            grads = torch.autograd.grad(loss, [t for _, t in
                                               tree_leaves(p)])
            res[where] = (logits, float(loss.detach()),
                          [t.cpu() for t in grads])
        (lo_card, l_card, g_card), (lo_cpu, l_cpu, g_cpu) = (
            res[dev.type], res["cpu"])
        logit_gap = float((lo_card - lo_cpu).abs().max()
                          / lo_cpu.abs().max())
        g_max = max(float(t.abs().max()) for t in g_cpu)
        g_gap = max(float((a - b).abs().max()) for a, b in
                    zip(g_card, g_cpu)) / g_max
        loss_gap = abs(l_card - l_cpu) / abs(l_cpu)
        ok = logit_gap <= TOL and loss_gap <= TOL and g_gap <= TOL
        log({"phase": "window_vs_cpu", "run": f"{arch} reduced W"
             f"{WINDOW_REDUCED} f32, card vs CPU", "logits_rel_gap":
             logit_gap, "loss_card": l_card, "loss_cpu": l_cpu,
             "loss_rel_gap": loss_gap, "grad_gap_rel_max": g_gap,
             "tol": TOL, "ok": ok})
        if not ok:
            raise SystemExit(f"{arch} with a window: card vs CPU logits "
                             f"{logit_gap}, loss {loss_gap}, gradient "
                             f"{g_gap}")
    B, L, H, KV, hd = 2, 4096, 14, 2, 64
    W = 1024
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = [t.requires_grad_() for t in flash_inputs(
            B, L, H, KV, hd, dtype, 33, dev)]
        g = torch.Generator(device=dev).manual_seed(34)
        do = torch.randn(B, L, H * hd, generator=g, device=dev).to(dtype)
        got = torch.autograd.grad(flash_attention_autograd(
            q, k, v, causal=True, q_block=512, window=W), (q, k, v), do)
        want = torch.autograd.grad(flash_attention_plain(
            q, k, v, causal=True, q_block=512, kv_block=1024, window=W),
            (q, k, v), do)
        errs = [float((a.float() - b.float()).abs().max())
                / float(b.float().abs().max()) for a, b in zip(got, want)]
        del got, want
        qd, kd, vd = q.detach(), k.detach(), v.detach()
        times = {
            "forward_ms": time_ms(lambda: flash_attention(
                qd, kd, vd, causal=True, window=W), 10),
            "vjp_ms": time_ms(lambda: attention_vjp(
                qd, kd, vd, do, causal=True, q_block=512, window=W), 3),
            "unwindowed_vjp_ms": time_ms(lambda: attention_vjp(
                qd, kd, vd, do, causal=True, q_block=512), 3)}
        name = str(dtype).split(".")[-1]
        log({"phase": "window_vs_cpu", "run": f"windowed attention "
             f"gradient {name}", "what": "flash_attention_autograd(window) "
             "vs autograd through flash_attention_plain(window), on the "
             "card", "shape_BLHKVhd": [B, L, H, KV, hd], "window": W,
             "max_rel_err_dq_dk_dv": errs, "tol": ATTN_GRAD_TOL[dtype],
             **times, "vjp_over_forward": times["vjp_ms"]
             / times["forward_ms"], "card": card})
        if not max(errs) <= ATTN_GRAD_TOL[dtype]:
            raise SystemExit(f"windowed attention gradient {name}: {errs}")
        del q, k, v, do, qd, kd, vd


def window_phase(dev, card, counted, expect, record_err, timings) -> None:
    """Phase 10, sliding-window attention: 10a the kernels
    (`window_kernels`), 10b the windowed prefill at full width
    (`window_prefill`), 10c long_500k decode (`long_decode`), 10d card
    vs CPU and the windowed gradient (`window_vs_cpu`)."""
    gc.collect()
    torch.cuda.empty_cache()
    window_kernels(dev, card, record_err, timings)
    window_prefill(dev, card, counted, expect)
    long_decode(dev, card, counted, expect)
    window_vs_cpu(dev, card)


def offset_kernels(dev, card, record_err, timings) -> None:
    """Each flash kernel with a query offset (``q_offset``, a rank's
    rows under "q_seq") at OFFSET_CASES, in both dtypes: two launches
    give the same bits, counted on the kernel `flash_route` names, on
    `flash_mha.offset_launches` (past offset 0) and on
    `window_launches`; against the plain version with the offset
    (float32 within FLASH_F32_RTOL of max |o|, bf16 within that plus one
    bf16 ULP); against the same rows of the whole call (its largest gap
    and whether it is bit for bit, logged; held to the same gate); each
    case timed (`window_times`: the kernel and its plain version in
    turns, the library's SDPA with the equivalent boolean mask, the
    kept pairs' bound with the offset).  Then RANK_FLASH's shapes timed,
    kernel alone.  `record_err(name, err, rel)` takes each check's gap;
    `timings[name, label]` each timed case."""
    from repro_torch.kernels import (LAUNCH_COUNTERS, flash_attention,
                                     flash_attention_plain, flash_mha,
                                     flash_route)

    def counts():
        return ({name: getattr(fn, attr) for name, (fn, attr)
                 in LAUNCH_COUNTERS.items() if name in FLASH_RECORDS.values()},
                flash_mha.offset_launches, flash_mha.window_launches)

    B, Lq, H, KV, hd = OFFSET_SHAPE
    for i, (q0, window) in enumerate(OFFSET_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            q_all, k, v = flash_inputs(B, OFFSET_KEYS, H, KV, hd, dtype,
                                       160 + i, dev)
            q = q_all[:, q0:q0 + Lq].contiguous()
            name = FLASH_RECORDS[flash_route(q)]
            kw = dict(causal=True, window=window, q_offset=q0)
            before = counts()
            o1 = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            o2 = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            after = counts()
            want = ({**before[0], name: before[0][name] + 2},
                    before[1] + (2 if q0 else 0),
                    before[2] + (2 if window else 0))
            if after != want:
                raise SystemExit(f"flash_attention(q_offset={q0}, window="
                                 f"{window}) launched {after} from {before}")
            plain = flash_attention_plain(q, k, v, **kw)
            whole = flash_attention(q_all, k, v, causal=True, window=window)[
                :, q0:q0 + Lq]
            torch.cuda.synchronize()
            gaps = {}
            for ref, w in (("plain", plain), ("whole call's rows", whole)):
                err = float((o1.float() - w.float()).abs().max())
                rel = err / float(w.float().abs().max())
                bf16 = dtype == torch.bfloat16
                gaps[ref] = dict(
                    max_abs_err=err, max_rel_err=rel,
                    max_bf16_ulps=bf16_ulps(o1, w) if bf16 else None,
                    bitwise=torch.equal(o1, w),
                    ok=(bf16_close(o1, w, FLASH_F32_RTOL) if bf16
                        else rel <= FLASH_F32_RTOL) and math.isfinite(rel))
            record_err(name, gaps["plain"]["max_abs_err"],
                       gaps["plain"]["max_rel_err"])
            label = (f"{LM_ARCH} q_seq rank rows B{B} L{Lq} of {OFFSET_KEYS} "
                     f"offset {q0}" + (f" W{window}" if window else ""))
            same = torch.equal(o1, o2)
            log({"phase": "offset", "kernel": name, "case": label,
                 "shape_BLHKVhd": list(OFFSET_SHAPE), "keys": OFFSET_KEYS,
                 "q_offset": q0, "window": window, "causal": True,
                 "dtype": str(dtype).split(".")[-1], "bitwise_repeat": same,
                 "vs": gaps, "card": card})
            if not (same and all(g["ok"] for g in gaps.values())):
                raise SystemExit(f"{name} with q_offset {q0} disagrees at "
                                 f"{label}: {gaps}, repeat {same}")
            timings[name, label] = window_times(
                name, label, q, k, v, True, window, plain, card,
                q_offset=q0)
            del q_all, q, k, v, o1, o2, plain, whole
    per_rank, queued = {}, {}
    for label, (B, L, H, KV, hd), S, q0 in RANK_FLASH:
        q, _, _ = flash_inputs(B, L, H, KV, hd, torch.float32, 170, dev)
        _, k, v = flash_inputs(B, S, H, KV, hd, torch.float32, 171, dev)
        call = lambda: flash_attention(q, k, v, q_offset=q0)
        per_rank[label] = [time_ms(call, 10) for _ in range(2)]
        queued[label] = [queued_ms(call, 10) for _ in range(2)]
        del q, k, v
    log({"phase": "offset_times", "what": "each phase-11 rank's flash call "
         "at float32, alone", "kernel_ms": per_rank,
         "kernel_queued_ms": queued,
         "shapes": {label: dict(shape_BLHKVhd=list(shape), keys=S,
                                q_offset=q0)
                    for label, shape, S, q0 in RANK_FLASH}, "card": card})


def kernel_inputs(B, U, K, N, seed, dev):
    """Edge-shape inputs: transmit symbols, amplitudes and an
    own-cluster mask (all ones for B = 1)."""
    g = torch.Generator().manual_seed(seed)
    t_re = (1e-2 * torch.randn(U, N, generator=g)).to(dev)
    t_im = (1e-2 * torch.randn(U, N, generator=g)).to(dev)
    amp = (0.2 + torch.rand(B, U, generator=g)).to(dev)
    w = torch.zeros(B, U)
    M = max(U // B, 1)
    for b in range(B):
        w[b, b * M:(b + 1) * M] = 1.0
    if B == 1:
        w[:] = 1.0
    return dict(args=(t_re, t_im, amp, w.to(dev)), K=K, sigma_h2=1.0,
                sigma_z2=1.0, block_u=32)


def hop_inputs(sc, hop: str, seed: int, dev, mult=None):
    """The kernel's inputs at one hop of `sc`'s round, built as
    `FusedBackend` builds them: transmit symbols P * pack(deltas) from
    random deltas at a round's scale, the topology's amplitudes and
    matched-filter weights, the round-0 power and the hop's antennas.
    `mult` [U], where given, precodes the deltas' rows (participation's
    transmit multipliers: 0 for an absent user, -2 for a byzantine one)."""
    from repro_torch import prng
    from repro_torch.core import aggregation, channel
    from repro_torch.core.topology import power_schedule
    from repro_torch.kernels import canonical_block_u

    topo = sc.make_topology()
    cfg = sc.whfl_config()
    P_t, P_is_t = power_schedule(0, cfg.power_base, cfg.power_slope,
                                 cfg.power_is_factor, cfg.power_low)
    two_n = aggregation.make_flat_spec(
        sc.task_fns()[0](prng.PRNGKey(seed))).two_n
    g = torch.Generator().manual_seed(seed)
    if hop == "cluster":
        U = topo.C * topo.M
        P, K, block_u = P_t, topo.K, canonical_block_u(topo.M)
        amp, w, _ = channel._cluster_geometry(topo, cfg.ota, dev)
    elif hop == "is_ps":
        U = topo.C
        P, K, block_u = P_is_t, topo.K_ps, 32
        amp, w, _ = channel._mac_geometry(topo.beta_is, dev)
    else:                                               # conventional
        U = topo.C * topo.M
        P, K, block_u = P_t, topo.K_ps, 32
        amp, w, _ = channel._mac_geometry(
            np.asarray(topo.beta_mu_ps).reshape(-1), dev)
    deltas = (1e-2 * torch.randn(U, two_n, generator=g)).to(dev)
    if mult is not None:
        deltas = deltas * mult.to(dev)[:, None]
    t = torch.as_tensor(P, dtype=torch.float32) * channel.pack_cx(deltas)
    return dict(args=(t.real.contiguous(), t.imag.contiguous(), amp, w),
                K=K, sigma_h2=topo.sigma_h2, sigma_z2=topo.sigma_z2,
                block_u=block_u)


def tile_inputs(sc, mesh, ci: int, ui: int, seed: int, dev, mult=None):
    """`fused_mac_partials`' inputs at shard (ci, ui) of `sc`'s u-sharded
    cluster hop on `mesh`, built as
    `repro_torch.exec.round.make_fused_cluster_hop` builds them: the
    shard's user tile and symbols of P * pack(deltas) from random deltas
    at a round's scale, the padded topology's amplitudes and own-cluster
    weights of that tile, the round-0 power, and the tile origin as the
    counter bases (rx_base, u_base, n_base).  `mult` [C, M], where given,
    precodes the deltas (as `hop_inputs`)."""
    import torch.nn.functional as F
    from repro_torch import prng
    from repro_torch.core import aggregation, channel
    from repro_torch.core.topology import pad_plan, power_schedule
    from repro_torch.exec.round import _tile
    from repro_torch.kernels import canonical_block_u

    topo = sc.make_topology()
    cfg = sc.whfl_config()
    P_t, _ = power_schedule(0, cfg.power_base, cfg.power_slope,
                            cfg.power_is_factor, cfg.power_low)
    two_n = aggregation.make_flat_spec(
        sc.task_fns()[0](prng.PRNGKey(seed))).two_n
    C, M, N = topo.C, topo.M, two_n // 2
    plan = pad_plan(C, M, mesh)
    U_loc = plan.Cp // mesh[0] * M
    N_loc = -(-N // mesh[1])
    r0, c0 = ci * U_loc, ui * N_loc
    amp, own, _ = channel._cluster_geometry(topo, cfg.ota, dev)
    cols = lambda x: F.pad(plan.pad_rx(x), (0, (plan.Cp - C) * M))[
        :, r0:r0 + U_loc].contiguous()
    g = torch.Generator(device=dev).manual_seed(seed)
    deltas = 1e-2 * torch.randn(C, M, two_n, generator=g, device=dev)
    if mult is not None:
        deltas = deltas * mult.to(dev)[..., None]
    t = (torch.as_tensor(P_t, dtype=torch.float32)
         * channel.pack_cx(deltas).reshape(C * M, N))
    return dict(args=(_tile(t.real, r0, r0 + U_loc, c0, c0 + N_loc),
                      _tile(t.imag, r0, r0 + U_loc, c0, c0 + N_loc),
                      cols(amp), cols(own)),
                K=topo.K, sigma_h2=topo.sigma_h2, sigma_z2=topo.sigma_z2,
                block_u=canonical_block_u(M), bases=(0, r0, c0))


def slab_inputs(sc, hop: str, seed: int, dev, mult=None):
    """`ota_combine`'s operands at one hop of `sc`'s round, built by
    `SlabKernelBackend` itself from random deltas at a round's scale, the
    topology, the round-0 power and the model's 2N: (h, t, z, w), with
    the unbatched layout and all-ones weights on a single-cell hop.
    `mult` [U], where given, precodes the deltas' rows (as
    `hop_inputs`)."""
    from repro_torch import prng
    from repro_torch.core import aggregation, channel
    from repro_torch.core.topology import power_schedule

    topo = sc.make_topology()
    cfg = sc.whfl_config()
    P_t, P_is_t = (torch.tensor(p, dtype=torch.float32) for p in
                   power_schedule(0, cfg.power_base, cfg.power_slope,
                                  cfg.power_is_factor, cfg.power_low))
    two_n = aggregation.make_flat_spec(
        sc.task_fns()[0](prng.PRNGKey(seed))).two_n
    g = torch.Generator().manual_seed(seed)
    key = prng.PRNGKey(seed, dev)
    slab = channel.SlabKernelBackend
    C, M = topo.C, topo.M
    precode = (lambda d: d) if mult is None else (
        lambda d: d * mult.to(dev).reshape(*d.shape[:-1], 1))
    if hop == "cluster":
        deltas = (1e-2 * torch.randn(C, M, two_n, generator=g)).to(dev)
        return slab.cluster_inputs(key, precode(deltas), topo, P_t, cfg.ota)
    if hop == "is_ps":
        U, beta, P = C, topo.beta_is, P_is_t
    else:                                               # conventional
        U, beta, P = C * M, np.asarray(topo.beta_mu_ps).reshape(-1), P_t
    deltas = precode((1e-2 * torch.randn(U, two_n, generator=g)).to(dev))
    h, t, z = slab.mac_inputs(key, deltas, beta, topo.K_ps, topo.sigma_h2,
                              topo.sigma_z2, P)
    return h, t, z, torch.ones(U, device=dev)


def edge_slab(B, U, K, N, seed, dev):
    """Random combine operands; B = None gives the unbatched layout."""
    g = torch.Generator().manual_seed(seed)
    lead = () if B is None else (B,)
    cx = lambda *shape: torch.randn(*shape, dtype=torch.complex64,
                                    generator=g).to(dev)
    return (cx(*lead, U, K, N), cx(U, N), cx(*lead, K, N),
            torch.randn(*lead, U, generator=g).to(dev))


def ota_label(sc) -> str:
    """``mode/backend`` of a scenario, with the mode's default named."""
    from repro_torch.core import channel
    if sc.ota_mode == "ideal":
        return "ideal"
    return f"{sc.ota_mode}/" + channel.resolve_backend(sc.whfl_config().ota)


def compare_runs(on_card, on_cpu) -> dict:
    """The card's run against the CPU's: max relative loss gap, max
    accuracy gap, and the final model's gap over its largest entry,
    leaf by leaf."""
    from repro_torch.tree import tree_leaves

    return {
        "loss_max_rel": float(np.max(np.abs(np.subtract(on_card.loss,
                                                        on_cpu.loss))
                                     / np.abs(on_cpu.loss))),
        "acc_max_abs": float(np.max(np.abs(np.subtract(on_card.acc,
                                                       on_cpu.acc)))),
        "theta_max_rel": max(
            float((x.cpu() - y.cpu()).abs().max() / y.cpu().abs().max())
            for (_, x), (_, y) in zip(
                tree_leaves(on_card.final_state["theta"]),
                tree_leaves(on_cpu.final_state["theta"])))}


def expected_slab_launches(doc: dict) -> int:
    """`ota_combine` launches a Fig. 2 driver document implies: per seed
    (``batch="map"``) or once for all seeds (``"vmap"``), rounds x (I +
    1) for W-HFL (I cluster hops and one IS->PS hop per round), rounds
    for conventional FL, none for the ideal baselines."""
    total = 0
    for rec in doc["scenarios"]:
        sc, rounds = rec["scenario"], rec["rounds"][-1]
        if sc["ota_mode"] == "ideal":
            per_seed = 0
        elif sc["mode"] == "conventional":
            per_seed = rounds
        else:
            per_seed = rounds * (sc["I"] + 1)
        total += per_seed * (len(rec["seeds"])
                             if rec["exec"]["batch"] == "map" else 1)
    return total


# cuDNN's convolution kernels, by name: its own (``cudnn::``) and the
# implicit-GEMM engines it runs a convolution's three passes on
CONV_KERNEL_MARKS = ("cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm",
                     "conv")


def device_profile(runner, sc) -> dict:
    """One seed of `sc` through `runner.run_scenario`, warm, then under
    `torch.profiler`: wall ms per round from ``drive_seconds``, and the
    device ops that start inside the runner's ``SweepRunner.drive``
    range (the drive begins and ends with a device synchronize, so they
    are exactly the rounds' and evals' device work; a chunked runner
    warmed up captures its graphs before the range, so only replays lie
    inside it)."""
    runner.run_scenario(sc)                                   # warm-up
    T = sc.rounds
    wall_ms = 1e3 * runner.run_scenario(sc).exec_info["drive_seconds"] / T
    with device_trace() as prof:
        runner.run_scenario(sc)
    ops, inside, drives = drive_ops(prof)
    out = {"rounds": T, "seed": runner.seeds[0], "driver": runner.driver,
           "wall_ms_per_round": wall_ms,
           "device_ms_whole_call": sum(e.duration_ns() for e in ops) / 1e6}
    if not drives or not inside:
        out["device_ms_per_round"] = "not measured"
        return out
    by_name = defaultdict(lambda: [0.0, 0])
    for e in inside:
        by_name[e.name()][0] += e.duration_ns() / 1e6 / T
        by_name[e.name()][1] += 1
    device_ms = sum(ms for ms, _ in by_name.values())
    conv_ms = sum(ms for k, (ms, _) in by_name.items()
                  if any(m in k.lower() for m in CONV_KERNEL_MARKS))
    rows = lambda items: [{"op": k[:72], "ms_per_round": ms,
                           "calls_per_round": n / T} for k, (ms, n) in items]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    out.update(device_ms_per_round=device_ms,
               device_busy_share=device_ms / wall_ms,
               device_ops_per_round=len(inside) / T,
               conv_ms_per_round=conv_ms, conv_share=conv_ms / device_ms,
               top=rows(top),
               kernels=rows((k, v) for k, v in by_name.items()
                            if any(fn in k for _, fn in KERNELS.values())))
    return out


def without_blocks(res, drop=("telemetry", "guard_trips")):
    """`res` with its final state's telemetry and guard blocks left out,
    to hold it against a run without them."""
    return dataclasses.replace(res, final_state={
        k: v for k, v in res.final_state.items() if k not in drop})


def bitwise_runs(a, b) -> dict:
    """Two runs' final states and metrics: equal bit for bit, and the
    largest gap in the final state where they are not."""
    from repro_torch.tree import tree_leaves

    la, lb = list(tree_leaves(a.final_state)), list(tree_leaves(b.final_state))
    state = len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))
    gap = max(float((x.float() - y.float()).abs().max())
              for (_, x), (_, y) in zip(la, lb))
    metrics = all(getattr(a, k) == getattr(b, k)
                  for k in ("acc", "loss", "edge_power", "is_power"))
    return {"state_bitwise_equal": state, "metrics_bitwise_equal": metrics,
            "state_max_abs_gap": gap}


def first_seed(res):
    """`res` cut to its first seed: each metric's first row and the
    first slice of its seed-stacked final state (a run of that seed
    alone gives the same bits: every seed runs on its own)."""
    from repro_torch.tree import tree_map

    return dataclasses.replace(
        res, seeds=res.seeds[:1], acc=res.acc[:1], loss=res.loss[:1],
        edge_power=res.edge_power[:1], is_power=res.is_power[:1],
        final_state=tree_map(lambda t: t[:1], res.final_state))


def theta_gaps(on_card, on_cpu, theta0=None, lr=None) -> dict:
    """The final models' largest gap over the whole flat vector, against
    its largest entry, and the same off the conv biases and the
    coordinates the OTA hops pack with them (n and n + N share a complex
    symbol); the conv biases' largest absolute gap, and every other
    entry's.  Given the initial model `theta0` and the learning rate
    `lr`: off those coordinates, the gap's norm against the norm of the
    CPU's update (theta - theta0), and the share of entries more than
    0.1 lr apart."""
    from repro_torch.core import aggregation
    from repro_torch.tree import tree_from_paths, tree_leaves, tree_map

    card = tree_map(lambda t: t.cpu(), on_card.final_state["theta"])
    cpu = on_cpu.final_state["theta"]
    spec = aggregation.make_flat_spec(cpu)
    fa, fb = aggregation.flatten(spec, card), aggregation.flatten(spec, cpu)
    is_bias = lambda p: "conv" in p and p[-1] == "b"
    bias = aggregation.flatten(spec, tree_from_paths(
        (p, torch.full_like(x, float(is_bias(p))))
        for p, x in tree_leaves(cpu))) > 0
    off = ~(bias | bias.roll(spec.two_n // 2))
    gap = lambda parts: max(float((x - y).abs().max()) for x, y in parts)
    out = {"theta_flat_max_rel": float((fa - fb).abs().max()
                                       / fb.abs().max()),
           "theta_flat_max_rel_off_conv_biases_and_partners": float(
               (fa - fb)[off].abs().max() / fb[off].abs().max()),
           "conv_bias_max_abs_gap": gap(
               (x, y) for (p, x), (_, y) in zip(tree_leaves(card),
                                                tree_leaves(cpu))
               if is_bias(p)),
           "other_max_abs_gap": gap(
               (x, y) for (p, x), (_, y) in zip(tree_leaves(card),
                                                tree_leaves(cpu))
               if not is_bias(p))}
    if theta0 is not None:
        f0 = aggregation.flatten(spec, theta0)
        out["update_rel_gap_off_conv_biases_and_partners"] = float(
            (fa - fb)[off].norm() / (fb - f0)[off].norm())
        out["share_off_conv_biases_and_partners_past_0.1_lr"] = float(
            ((fa - fb)[off].abs() > 0.1 * lr).float().mean())
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a CUDA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import channel
    from repro_torch.exec import (ShardedSweepRunner, make_device_mesh,
                                  make_fused_cluster_hop, parse_mesh)
    from repro_torch.fed import ParticipationSchedule
    from repro_torch.kernels import (LAUNCH_COUNTERS, build, flash_attention,
                                     flash_attention_plain, flash_mha,
                                     flash_route, fused_mac,
                                     fused_mac_partials,
                                     fused_mac_partials_plain,
                                     fused_mac_plain, fused_partials_reduce,
                                     fused_partials_reduce_plain,
                                     ota_combine, ota_combine_plain, sass)
    from repro_torch.sim import SweepRunner, get_scenario, sweep

    # -- phase 1: the card -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's deterministic algorithms, chosen by its heuristics, not by
    # timing: the CNN's runs repeat bit for bit across drivers and meshes
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log({"phase": "card", "kind": kind, "nvidia_smi": smi,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0]})

    # -- phase 2: build, one nvcc per source, all at once -------------------
    t0 = time.perf_counter()
    build.load_all(list(SOURCES))
    wall = round(time.perf_counter() - t0, 3)
    for name in SOURCES:
        build_s, nvcc_log = build.build_info(name)
        log({"phase": "build", "source": f"csrc/{name}.cu",
             "kernels": [k for k, (src, _) in KERNELS.items()
                         if src == name], "seconds": wall,
             "nvcc_seconds": round(build_s, 3),
             "ptxas": [ln.strip() for ln in nvcc_log.splitlines()
                       if "registers" in ln or "spill" in ln
                       or "entry function" in ln]})
    # each draw kernel's operations per draw, by pipe, from its SASS
    report = sass.analyse(sass.disassemble(build.library_path("fused_mac")),
                          build.build_info("fused_mac")[1])
    cycles = {}
    for name, (src, fn) in KERNELS.items():
        if src != "fused_mac":
            continue
        rec = report.get(fn)
        if rec is None or "cycles_per_draw" not in rec:
            raise SystemExit(f"no draw loop found in the SASS of {fn}")
        cycles[name] = rec["cycles_per_draw"]
        log({"phase": "sass", "kernel": name, "function": fn, **rec})
    # the tensor-core flash kernels run on wgmma (HGMMA) fed by TMA
    # (UTMALDG): each template instance, in this run's SASS
    for record, instances in TENSOR_CORE_FLASH.items():
        src, fn = KERNELS[record]
        funcs = {k: v for k, v in sass.parse(sass.disassemble(
            build.library_path(src))).items() if sass.short_name(k) == fn}
        resources = sass.ptxas_resources(build.build_info(src)[1])
        for mangled, instrs in funcs.items():
            ops = defaultdict(int)
            for ins in instrs:
                ops[ins.base] += 1
            counts = {op: ops[op] for op in ("HGMMA", "UTMALDG", "LDL",
                                             "STL", "MUFU")}
            log({"phase": "sass", "kernel": record,
                 "function": mangled, "instructions": len(instrs),
                 "hgmma_shapes": sorted({i.op for i in instrs
                                         if i.base == "HGMMA"}),
                 **counts, **resources.get(mangled, {})})
            if not (counts["HGMMA"] and counts["UTMALDG"]):
                raise SystemExit(f"{mangled} has no HGMMA or no UTMALDG in "
                                 f"its SASS: {counts}")
        if len(funcs) != instances:
            raise SystemExit(f"want {instances} instances of {fn}, found "
                             f"{list(funcs)}")

    # -- phase 3: kernels vs plain versions at the main paths' shapes -------
    seed = torch.tensor([0xC0FFEE, 42], dtype=torch.int64, device=dev)
    fig2 = get_scenario("fig2_iid").replace(total_IT=5)
    fig2_fused = fig2.replace(ota_mode="faithful", ota_backend="fused")
    fig2_slab = fig2.replace(ota_mode="faithful", ota_backend="slab_kernel")
    # Fig. 3 at the paper's sizes (C 4, M 5, K = K_ps = 100, batch 128,
    # tau 5, n_train 20,000, n_test 1,000, Adam at 1e-3), its 400 rounds
    # cut to FIG3_ROUNDS for the run's time
    fig3 = get_scenario("fig3_cifar").replace(total_IT=FIG3_ROUNDS)
    fig3_fused = fig3.replace(ota_mode="faithful", ota_backend="fused")
    u256 = get_scenario("scale_u256")
    u256_slab = u256.replace(ota_backend="slab_kernel")
    cases = [("edge", (0, 0, 0), kernel_inputs(1, 1, 1, 64, 0, dev)),
             ("edge", (2, 3, 5), kernel_inputs(3, 5, 7, 130, 1, dev)),
             ("edge", (0, 0, 0), kernel_inputs(1, 70, 100, 1000, 2, dev))]
    u16384 = get_scenario("scale_u16384")
    u65536 = get_scenario("scale_u65536")
    for i, (sc, hop) in enumerate([(u256, "cluster"), (u256, "is_ps"),
                                   (fig2_fused, "cluster"),
                                   (fig2_fused, "is_ps"),
                                   (u16384, "is_ps"), (u65536, "is_ps"),
                                   (fig3_fused, "cluster"),
                                   (fig3_fused, "is_ps")]):
        cases.append((f"{sc.name} {hop}", (0, 0, 0),
                      hop_inputs(sc, hop, 10 + i, dev)))
    # participation's precoded users on fig2's three fused hops: the
    # realised transmit multipliers of a Bernoulli round at fig2_drop50's
    # rate with fig2_byzantine3's flags (absent rows exactly 0, byzantine
    # rows -2 x), and the IS rows with one silent and one -2 x station
    part = ParticipationSchedule(kind="bernoulli", rate=0.5, n_byzantine=3,
                                 byzantine_scale=2.0)
    mult = (part.present(0, fig2.C, fig2.M)
            * torch.as_tensor(part.tx_base(fig2.C, fig2.M))).reshape(-1)
    mult_is = torch.tensor([1.0, 0.0, -2.0, 1.0])
    if not (bool((mult == 0).any()) and bool((mult == -2).any())):
        raise SystemExit(f"the precoded rows hold no 0 or no -2: {mult}")
    precoded = [("cluster", mult), ("is_ps", mult_is),
                ("conventional", mult)]
    for i, (hop, m) in enumerate(precoded):
        cases.append((f"fig2 {hop} precoded", (0, 0, 0),
                      hop_inputs(fig2_fused, hop, 110 + i, dev, m)))
    errors = {name: 0.0 for name in KERNELS}
    rel_errors = {name: 0.0 for name in KERNELS}

    def check(name, label, shape, y1, y2, want):
        """Hold two launches' results to the plain version's: a (re, im)
        pair against its complex magnitude, other outputs each against
        its own largest entry."""
        same = all(torch.equal(a, b) for a, b in zip(y1, y2))
        errs = [float((a - b).abs().max()) for a, b in zip(y1, want)]
        err = max(errs)
        if len(want) == 2:
            scale = float(torch.complex(*want).abs().max())
            rel = err / scale if scale > 0 else err
        else:
            rel = max(e / float(b.abs().max()) if float(b.abs().max()) > 0
                      else e for e, b in zip(errs, want))
        errors[name] = max(errors[name], err)
        rel_errors[name] = max(rel_errors[name], rel)
        log({"phase": "kernel_vs_plain", "kernel": name, "case": label,
             "shape_BUKN": list(shape), "max_abs_err": err,
             "max_rel_err": rel, "bitwise_repeat": same,
             "bitwise_equal_to_plain": all(torch.equal(a, b)
                                           for a, b in zip(y1, want))})
        if not (same and rel <= TOL and math.isfinite(rel)):
            raise SystemExit(f"{name} disagrees with its plain version at "
                             f"{label} {shape}: rel {rel}, repeat {same}")

    for label, (rb, ub, nb), inp in cases:
        args = inp["args"]
        B, U = args[2].shape
        K, N = inp["K"], args[0].shape[1]
        kw = dict(K=K, sigma_h2=inp["sigma_h2"], sigma_z2=inp["sigma_z2"],
                  rx_base=rb, u_base=ub, n_base=nb, block_u=inp["block_u"])
        y1 = fused_mac(seed, *args, **kw)
        torch.cuda.synchronize()
        y2 = fused_mac(seed, *args, **kw)
        want = fused_mac_plain(seed, *args, **kw)
        torch.cuda.synchronize()
        check("fused_mac", f"{label} bases {[rb, ub, nb]}", (B, U, K, N),
              y1, y2, want)

    slab_cases = [(f"{sc.name} {hop}", lambda sc=sc, hop=hop, i=i:
                   slab_inputs(sc, hop, 20 + i, dev))
                  for i, (sc, hop) in enumerate([
                      (fig2_slab, "cluster"), (fig2_slab, "is_ps"),
                      (fig2_slab.replace(mode="conventional"),
                       "conventional"), (u256_slab, "cluster")])]
    slab_cases += [(f"fig2_iid {hop} precoded", lambda hop=hop, m=m, i=i:
                    slab_inputs(fig2_slab.replace(mode="conventional")
                                if hop == "conventional" else fig2_slab,
                                hop, 120 + i, dev, m))
                   for i, (hop, m) in enumerate(precoded)]
    for i, (U, K, N) in enumerate([(1, 1, 64), (4, 7, 130), (3, 33, 513)]):
        for B in (None, 3):
            slab_cases.append((f"edge B={B or 1}", lambda B=B, U=U, K=K,
                               N=N, i=i: edge_slab(B, U, K, N, 30 + i, dev)))
    for label, make in slab_cases:
        args = make()
        shape = tuple(args[0].shape) if args[0].dim() == 4 else (
            1, *args[0].shape)
        y1 = ota_combine(*args)
        torch.cuda.synchronize()
        y2 = ota_combine(*args)
        want = ota_combine_plain(*args)
        torch.cuda.synchronize()
        check("ota_combine", label, shape, (y1,), (y2,), (want,))
        del args, y1, y2, want

    # seed batching (``batch="vmap"``): S_SEEDS seeds of fig2's and
    # scale_u256's hops, and FIG3_VMAP_SEEDS of Fig. 3's (the seeds of
    # phase 4's fig3 vmap run), in one launch, their gains shared with a
    # seed stride of 0 as the vmapped hops pass them; the launch against
    # the S unbatched ones bit for bit, and against the plain version
    # with its seed axis within TOL
    def seed_batched(name, label, shape, call, args):
        """One seed-batched launch (twice, for the repeat check) against
        S unbatched ones, S the leading axis of `args`; returns its
        outputs."""
        fn = counters[name][0]
        before = fn.launches
        y1, y2 = call(*args), call(*args)
        torch.cuda.synchronize()
        launches = fn.launches - before
        pair = lambda y: y if isinstance(y, tuple) else (y,)
        S = args[0].shape[0]
        singles = [pair(call(*(a[s] for a in args))) for s in range(S)]
        same = all(torch.equal(a[s], b) for s, one in enumerate(singles)
                   for a, b in zip(pair(y1), one))
        log({"phase": "seed_batched", "kernel": name, "case": label,
             "shape_SBUKN": list(shape), "launches_for_two_calls": launches,
             "bitwise_equal_to_unbatched_launches": same})
        if not same or launches != 2:
            raise SystemExit(f"{name} at {label}: a seed-batched launch "
                             f"differs from {S} unbatched ones")
        return pair(y1), pair(y2)

    counters = LAUNCH_COUNTERS
    for i, (sc, hop, S) in enumerate([
            (fig2_fused, "cluster", S_SEEDS), (fig2_fused, "is_ps", S_SEEDS),
            (u256, "cluster", S_SEEDS), (u256, "is_ps", S_SEEDS),
            (fig3_fused, "cluster", FIG3_VMAP_SEEDS),
            (fig3_fused, "is_ps", FIG3_VMAP_SEEDS)]):
        inps = [hop_inputs(sc, hop, 200 + 10 * i + s, dev) for s in range(S)]
        inp = inps[0]
        amp, w = inp["args"][2:]          # the geometry: every seed's
        args = (torch.tensor([[0xC0FFEE, 42 + s] for s in range(S)],
                             dtype=torch.int64, device=dev),
                *(torch.stack([x["args"][j] for x in inps]) for j in (0, 1)),
                amp.expand(S, *amp.shape), w.expand(S, *w.shape))
        del inps
        kw = dict(K=inp["K"], sigma_h2=inp["sigma_h2"],
                  sigma_z2=inp["sigma_z2"], block_u=inp["block_u"])
        N = args[1].shape[-1]
        shape = (S, *amp.shape, inp["K"], N)
        label = f"{sc.name} {hop} S={S}"
        y1, y2 = seed_batched("fused_mac", label, shape,
                              lambda *a: fused_mac(*a, **kw), args)
        if sc is fig3_fused and hop == "cluster":
            # the plain version on the first and the last FIG3_WINDOW
            # symbols (its intermediates at the whole hop and 2 seeds
            # would not fit on the card): a symbol's output depends on
            # its own column alone, and n_base numbers the columns
            cols = [(0, FIG3_WINDOW), (N - FIG3_WINDOW, N)]
            cut = lambda ys: tuple(torch.cat([y[..., a:b] for a, b in cols],
                                             -1) for y in ys)
            want = [fused_mac_plain(args[0], args[1][..., a:b],
                                    args[2][..., a:b], *args[3:],
                                    n_base=a, **kw) for a, b in cols]
            want = tuple(torch.cat(p, -1) for p in zip(*want))
            check("fused_mac", f"{label} symbols {cols}", shape, cut(y1),
                  cut(y2), want)
        else:
            check("fused_mac", label, shape, y1, y2,
                  fused_mac_plain(*args, **kw))
        del args, y1, y2
    for i, (sc, hop) in enumerate([(fig2_slab, "cluster"),
                                   (fig2_slab, "is_ps"),
                                   (u256_slab, "cluster")]):
        ops = [slab_inputs(sc, hop, 230 + 10 * i + s, dev)
               for s in range(S_SEEDS)]
        h, t, z = (torch.stack([o[j] for o in ops]) for j in range(3))
        w = ops[0][3]                     # all ones or the own-cluster mask
        if h.dim() == 4:                  # a single-cell hop: B = 1
            h, z, w = h[:, None], z[:, None], w[None]
        args = (h, t, z, w.expand(S_SEEDS, *w.shape))
        label = f"{sc.name} {hop} S={S_SEEDS}"
        y1, y2 = seed_batched("ota_combine", label, tuple(h.shape),
                              ota_combine, args)
        check("ota_combine", label, tuple(h.shape), y1, y2,
              (ota_combine_plain(*args),))
        del ops, h, t, z, args, y1, y2

    # the partial combine at the u-sharded hop's shapes: each kernel
    # against its plain version, and partials + fold against fused_mac
    # bit for bit (at scale_u65536 the kernels only here: its plain
    # version takes ~20 s a call, so phase 7 holds both kernels to it on
    # the call it times)

    def edge_tile():
        inp = kernel_inputs(3, 40, 7, 130, 3, dev)
        return {**inp, "block_u": 8, "bases": (2, 40, 5)}

    partial_cases = [
        ("scale_u256 1x1", lambda: tile_inputs(u256, (1, 1), 0, 0, 60, dev),
         True),
        ("scale_u256 2x4 tile (1, 1)",
         lambda: tile_inputs(u256, (2, 4), 1, 1, 61, dev), True),
        ("scale_u16384 1x1",
         lambda: tile_inputs(u16384, (1, 1), 0, 0, 62, dev), True),
        ("edge", edge_tile, True),
        ("fig3_cifar 2x5 tile (1, 3)",
         lambda: tile_inputs(fig3_fused, (2, 5), 1, 3, 64, dev), True),
        # a padded tile (fig2 on 3x2 pads 4x5 to 6x6) fed precoded users
        ("fig2_iid 3x2 tile (1, 1) precoded",
         lambda: tile_inputs(fig2_fused, (3, 2), 1, 1, 65, dev,
                             mult.reshape(fig2.C, fig2.M)), True),
        ("scale_u65536 1x1",
         lambda: tile_inputs(u65536, (1, 1), 0, 0, 63, dev), False)]
    for label, make, with_plain in partial_cases:
        inp = make()
        args, (rb, ub, nb) = inp["args"], inp["bases"]
        B, U = args[2].shape
        K, N, bu = inp["K"], args[0].shape[1], inp["block_u"]
        kw = dict(K=K, sigma_h2=inp["sigma_h2"], rx_base=rb, u_base=ub,
                  n_base=nb, block_u=bu)
        fold = dict(K=K, sigma_z2=inp["sigma_z2"], rx_base=rb, n_base=nb)
        p1 = fused_mac_partials(seed, *args, **kw)
        torch.cuda.synchronize()
        p2 = fused_mac_partials(seed, *args, **kw)
        y1 = fused_partials_reduce(seed, *p1, **fold)
        torch.cuda.synchronize()
        y2 = fused_partials_reduce(seed, *p2, **fold)
        y = fused_mac(seed, *args, sigma_z2=inp["sigma_z2"], **kw)
        torch.cuda.synchronize()
        shape = (B, U, K, N)
        if with_plain:
            check("fused_mac_partials", f"{label} block_u {bu}", shape, p1,
                  p2, fused_mac_partials_plain(seed, *args, **kw))
            check("fused_partials_reduce", label, (B, U // bu, K, N), y1, y2,
                  fused_partials_reduce_plain(seed, *p1, **fold))
        elif not all(torch.equal(a, b) for a, b in zip(p1 + y1, p2 + y2)):
            raise SystemExit(f"the partial kernels' bits differ between "
                             f"two launches at {label}")
        same = all(torch.equal(a, b) for a, b in zip(y1, y))
        log({"phase": "partials_and_reduce_vs_fused_mac", "case": label,
             "shape_BUKN": list(shape), "block_u": bu,
             "bases": [rb, ub, nb], "bitwise_equal": same,
             "max_abs_gap": max(float((a - b).abs().max())
                                for a, b in zip(y1, y))})
        if not same:
            raise SystemExit(f"partials + reduce differ from fused_mac at "
                             f"{label}")
        del inp, args, p1, p2, y1, y2, y

    # flash attention at the serving path's shapes and the JAX tests'
    def flash_counts():
        return {name: getattr(*counters[name])
                for name in FLASH_RECORDS.values()}

    def flash_pair(q, k, v, causal):
        """Two launches, and the record of the kernel that served both:
        the one `flash_route` names, and it alone (by the counts)."""
        name = FLASH_RECORDS[flash_route(q)]
        before = flash_counts()
        o1 = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        o2 = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if flash_counts() != {**before, name: before[name] + 2}:
            raise SystemExit(f"flash_attention launched {flash_counts()} "
                             f"from {before}, not 2 of {name}")
        return name, o1, o2

    def check_flash(name, label, shape, dtype, causal, o1, o2, want):
        """Two launches' outputs against the plain version's: f32 within
        FLASH_F32_RTOL of max |o|, bf16 within that plus one bf16 ULP
        (`bf16_close`)."""
        same = torch.equal(o1, o2)
        err = float((o1.float() - want.float()).abs().max())
        rel = err / float(want.float().abs().max())
        ulps = bf16_ulps(o1, want) if dtype == torch.bfloat16 else None
        errors[name] = max(errors[name], err)
        rel_errors[name] = max(rel_errors[name], rel)
        log({"phase": "kernel_vs_plain", "kernel": name,
             "case": label, "shape_BLHKVhd": list(shape),
             "dtype": str(dtype).split(".")[-1], "causal": causal,
             "max_abs_err": err, "max_rel_err": rel, "max_bf16_ulps": ulps,
             "bitwise_repeat": same})
        ok = (bf16_close(o1, want, FLASH_F32_RTOL) if ulps is not None
              else rel <= FLASH_F32_RTOL)
        if not (same and ok and math.isfinite(rel)):
            raise SystemExit(f"{name} disagrees with its plain version "
                             f"at {label} {shape}: rel {rel}, bf16 ulps "
                             f"{ulps}, repeat {same}")

    bf16, f32 = torch.bfloat16, torch.float32
    # one tile first (64 rows of one head, 64 keys): the hd-16 and hd-32
    # instances' swizzles and descriptors, before anything larger
    flash_cases = [(f"one tile hd {hd}", (1, 64, 1, 1, hd), dtype, True)
                   for hd in (32, 16) for dtype in (bf16, f32)] + [
        (f"{LM_ARCH} prefill B4 L4096", (4, 4096, 14, 2, 64), bf16, True),
        (f"{LM_ARCH} prefill B4 L4096", (4, 4096, 14, 2, 64), f32, True),
        # bidirectional: every row averages 4,096 keys, so max |o| is
        # small and the float32 gate tightest
        (f"{LM_ARCH} B4 L4096 bidirectional", (4, 4096, 14, 2, 64), f32,
         False),
        ("qwen2-1.5b prefill B1 L4096", (1, 4096, 12, 2, 128), bf16, True),
        ("qwen2-1.5b prefill B1 L4096", (1, 4096, 12, 2, 128), f32, True),
        ("qwen3-4b prefill B1 L4096", (1, 4096, 32, 8, 128), bf16, True),
        # 128-row tiles that hold rows of two heads (7 x 200 folded rows)
        (f"{LM_ARCH} heads L200 (fold straddles tiles)",
         (2, 200, 14, 2, 64), bf16, True),
        ("qwen2-1.5b heads bidirectional", (1, 1000, 12, 2, 128), bf16,
         False),
        # the float32 tensor-core kernel's edges: straddling tiles, rows
        # and keys not multiples of its tiles, both masks
        (f"{LM_ARCH} heads L200 f32 (fold straddles tiles)",
         (2, 200, 14, 2, 64), f32, True),
        (f"{LM_ARCH} heads L200 f32 bidirectional", (2, 200, 14, 2, 64), f32,
         False),
        (f"{LM_ARCH} heads L77 f32", (1, 77, 14, 2, 64), f32, True),
        # its hd-128 instance's: 32-key tiles, 2 K stages, 1 V^T stage
        ("qwen2-1.5b heads L200 f32 (fold straddles tiles)",
         (2, 200, 12, 2, 128), f32, True),
        ("qwen2-1.5b heads L200 f32 bidirectional", (2, 200, 12, 2, 128),
         f32, False),
        ("qwen2-1.5b heads L77 f32", (1, 77, 12, 2, 128), f32, True),
        ("qwen3-4b heads L1000 f32 bidirectional", (1, 1000, 32, 8, 128),
         f32, False),
        # the hd-32 instances' main path: the serving example's model
        # prefilled at B4 L4096, at bf16 and at float32 compute
        (f"{LM_ARCH} reduced prefill B4 L4096", (4, 4096, 4, 2, 32), bf16,
         True),
        (f"{LM_ARCH} reduced prefill B4 L4096", (4, 4096, 4, 2, 32), f32,
         True),
        ("test_flash_attn bf16", (1, 64, 4, 2, 32), bf16, True),
        # hd 112 (zamba2-7b's shared attention) on the hd-128 instances,
        # columns 112 .. 127 read as zeros: one tile first, then its
        # prefill shape (32 heads over 32 KV heads), both masks and
        # dtypes, and a ragged L (1,000 rows: 7 full tiles and 104)
        ("one tile hd 112", (1, 64, 1, 1, 112), bf16, True),
        ("one tile hd 112", (1, 64, 1, 1, 112), f32, True),
        ("zamba2-7b prefill B4 L4096", (4, 4096, 32, 32, 112), bf16, True),
        ("zamba2-7b prefill B4 L4096", (4, 4096, 32, 32, 112), f32, True),
        ("zamba2-7b B4 L4096 bidirectional", (4, 4096, 32, 32, 112), bf16,
         False),
        ("zamba2-7b B4 L4096 bidirectional", (4, 4096, 32, 32, 112), f32,
         False),
        ("zamba2-7b heads L1000", (1, 1000, 32, 32, 112), bf16, True),
        ("zamba2-7b heads L1000", (1, 1000, 32, 32, 112), f32, True),
        ("hd 112 G 4 L200 (fold straddles tiles)", (2, 200, 8, 2, 112),
         f32, False)] + [
        ("test_flash_attn", shape, dtype, causal)
        for shape in JAX_FLASH_SHAPES for dtype in (f32, bf16)
        for causal in (True, False)]
    for i, (label, shape, dtype, causal) in enumerate(flash_cases):
        q, k, v = flash_inputs(*shape, dtype, 80 + i, dev)
        name, o1, o2 = flash_pair(q, k, v, causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check_flash(name, label, shape, dtype, causal, o1, o2, want)
        del q, k, v, o1, o2, want

    # -- phase 4: the main paths -------------------------------------------
    main_launches = {name: 0 for name in KERNELS}
    fig2_ref = fig2.replace(ota_mode="faithful")          # reference backend
    drop50_fused = get_scenario("fig2_drop50").replace(
        total_IT=5, ota_mode="faithful", ota_backend="fused")
    byz1_median = get_scenario("fig2_byzantine1_median").replace(total_IT=5)
    fig3_cut = dict(total_IT=1, C=2, M=2, batch=32)
    # the CPU runs phase 5 (and the telemetry check) compare with, longest
    # first: (label, scenario, seeds, mesh)
    cpu_dir = tempfile.mkdtemp(prefix="cpu_runs_")
    cpu_pool = ThreadPoolExecutor(max_workers=CPU_WORKERS)
    cpu_jobs = {}

    def cpu_run(label, sc, seeds, mesh=None):
        out = str(Path(cpu_dir) / f"{len(cpu_jobs)}.pt")
        arg = json.dumps({"scenario": sc.to_json(), "seeds": seeds,
                          "mesh": mesh, "out": out})

        def job():
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", CPU_RUN_SNIPPET,
                                   arg], cwd=str(ROOT), capture_output=True,
                                  text=True, timeout=1000)
            if proc.returncode != 0:
                raise RuntimeError(f"the CPU run {label} failed:\n"
                                   f"{proc.stderr[-3000:]}")
            return out, time.perf_counter() - t0

        cpu_jobs[label] = cpu_pool.submit(job)

    def cpu_result(label):
        """A CPU run's result, and its seconds (in its own process)."""
        out, seconds = cpu_jobs.pop(label).result()
        return SimpleNamespace(**torch.load(out)), seconds

    for label, sc, seeds, mesh in (
            ("scale_u256", u256, 2, None),
            ("fig3_cifar_fused sgd", fig3_fused.replace(opt="sgd",
                                                        **fig3_cut), 1, None),
            ("fig3_cifar_fused", fig3_fused.replace(**fig3_cut), 1, None),
            ("scale_u256 sharded 2x4 u_sharded", u256, 2, "2x4"),
            ("fig2_iid_slab", fig2_slab.replace(total_IT=1), 2, None),
            ("fig2_drop50_fused", drop50_fused.replace(total_IT=2), 2, None),
            ("fig2_iid_reference", fig2_ref.replace(total_IT=1), 2, None),
            ("fig2_iid_fused telemetry", fig2_fused.replace(
                total_IT=2, telemetry=True), [0], None),
            ("fig2_byzantine1_median", byz1_median.replace(total_IT=2), 2,
             None),
            ("fig2_iid", fig2.replace(total_IT=2), 2, None),
            ("fig3_cifar_ideal", get_scenario("fig3_cifar_ideal").replace(
                **fig3_cut), 1, None)):
        cpu_run(label, sc, seeds, mesh)

    def finite(res) -> bool:
        metrics = [getattr(res, k) for k in ("acc", "loss", "edge_power",
                                             "is_power")]
        return bool(np.all(np.isfinite(np.asarray(metrics, np.float64))))

    expect = functools.partial(check_launches, totals=main_launches)

    def chunked_launches(label, run, want):
        """`run()`, whose drives are chunked and warmed up (so they hold
        graph replays only), and the launches of our kernels in them,
        which must be `want`.  A replay runs no Python, so the wrappers'
        counters do not see it: they read the eager run before each
        capture and the capture's recording.  Where `want` has a launch,
        the drives' replays count them from the graphs (`count_drives`:
        each graph's kernel nodes at its capture times its replays),
        and a trace of the drives must see no more (it may see fewer:
        a trace can lose a long replay's device records, `trace_probe
        --replays`); where it has none, counters that read 0 show that no
        wrapper was called, so no graph holds a kernel of ours.  Neither
        is added to the kernels line, whose launches are the stepwise
        runs' counters."""
        full = {n: want.get(n, 0) for n in KERNELS}
        if not any(full.values()):
            out, seen = counted(run)
            log({"phase": "chunked_launches", "run": label,
                 "expected_launches": full,
                 "counters_eager_and_capture": seen})
            traced = seen
        else:
            (out, seen, traced), counts = counted(
                lambda: count_drives(run, KERNEL_FUNCTIONS, SweepRunner))
            log({"phase": "chunked_launches", "run": label,
                 "kernel_launches_replayed": seen,
                 "kernel_launches_traced": traced,
                 "expected_launches": full,
                 "counters_eager_and_capture": counts})
        if seen != full or any(traced[n] > full[n] for n in traced):
            raise SystemExit(f"{label}: {seen} launches in the chunked "
                             f"drive ({traced} traced), the stepwise run "
                             f"{full}")
        return out

    def chunked_rerun(label, make_runner, step, want):
        """`make_runner()`'s run, the same sweep through the chunked
        driver (its graphs captured and replayed once before the drive),
        against its stepwise run `step`: the same bits (final state and
        every metric), and the stepwise run's launches in a trace of the
        chunked drive (`chunked_launches`)."""
        res = chunked_launches(f"{label} chunked",
                               lambda: make_runner().run()[0], want)
        same = bitwise_runs(step, res)
        log({"phase": "chunked_vs_stepwise", "run": label, **same,
             "dispatches": res.exec_info["dispatches"],
             "finite": finite(res)})
        if not (same["state_bitwise_equal"] and same["metrics_bitwise_equal"]
                and finite(res)):
            raise SystemExit(f"{label}: the chunked driver's run differs "
                             f"from the stepwise one: {same}")

    runs = [("scale_u256", u256, True), ("fig2_iid_fused", fig2_fused, True),
            ("fig2_iid_reference", fig2_ref, False), ("fig2_iid", fig2, False)]
    for label, sc, fused in runs:
        make = lambda driver="stepwise", warmup=False, sc=sc: SweepRunner(
            [sc], seeds=2, device="cuda", keep_state=True, driver=driver,
            warmup=warmup, batch="map")
        res, launches = counted(lambda: make().run()[0])
        if label == "scale_u256":
            u256_on_card = res
        if label == "fig2_iid_fused":
            fig2_fused_on_card = res
        rounds = res.rounds[-1]
        log({"phase": "main_path", "run": label, "scenario": sc.name,
             "C": sc.C, "M": sc.M, "K": sc.K, "K_ps": sc.K_ps,
             "ota": ota_label(sc),
             "seeds": res.seeds, "rounds": rounds,
             "rounds_per_sec": rounds / res.exec_info["drive_seconds"],
             "drive_seconds": res.exec_info["drive_seconds"],
             "final_acc": [a[-1] for a in res.acc],
             "final_loss": [v[-1] for v in res.loss]})
        want = {"fused_mac": 2 * rounds * len(res.seeds) if fused else 0}
        expect(label, launches, want, finite(res))
        chunked_rerun(label, lambda: make("chunked", True), res, want)

    # Fig. 3: the CIFAR CNN at the paper's sizes, as registered (the
    # equivalent channel, no kernel), faithful with the fused backend,
    # and on the sharded engine (1x1 and 2x5, u_sharded), each through
    # both drivers but 1x1 (stepwise only, for the run's time); the
    # chunked driver with the first seed alone, held to that seed of the
    # stepwise run (capturing the 2x5 tiles' graphs took 76 s for two
    # seeds)
    fig3_on_card = {}
    for label, sc, mesh in (
            ("fig3_cifar", fig3, None), ("fig3_cifar_fused", fig3_fused, None),
            ("fig3_cifar_fused sharded 1x1 u_sharded", fig3_fused, "1x1"),
            ("fig3_cifar_fused sharded 2x5 u_sharded", fig3_fused, "2x5")):
        def make(driver="stepwise", warmup=False, seeds=2, sc=sc, mesh=mesh):
            kw = dict(seeds=seeds, device="cuda", keep_state=True,
                      driver=driver, warmup=warmup)
            if mesh is None:
                return SweepRunner([sc], batch="map", **kw)
            return ShardedSweepRunner([sc], mesh=mesh, combine="u_sharded",
                                      **kw)

        def fig3_want(res, sc=sc, mesh=mesh):
            hops = res.rounds[-1] * len(res.seeds) * sc.I  # cluster hops
            if mesh is None:
                return {"fused_mac": 2 * hops if sc.ota_backend == "fused"
                        else 0}
            mc, mu = parse_mesh(mesh)
            return {"fused_mac_partials": hops * mc * mu,
                    "fused_partials_reduce": hops * mu,
                    "fused_mac": res.rounds[-1] * len(res.seeds)}

        res, launches = counted(lambda: make().run()[0])
        want = fig3_want(res)
        log({"phase": "main_path", "run": label, "scenario": sc.name,
             "C": sc.C, "M": sc.M, "K": sc.K, "K_ps": sc.K_ps,
             "batch": sc.batch, "tau": sc.tau, "n_train": sc.n_train,
             "n_test": sc.n_test, "opt": sc.opt, "lr": sc.lr,
             "ota": ota_label(sc), "mesh": mesh, "seeds": res.seeds,
             "rounds": res.rounds[-1],
             "cut": f"total_IT 400 -> {FIG3_ROUNDS}",
             "rounds_per_sec": res.rounds[-1]
             / res.exec_info["drive_seconds"],
             "final_acc": [a[-1] for a in res.acc],
             "final_loss": [v[-1] for v in res.loss]})
        expect(label, launches, want, finite(res))
        if mesh != "1x1":
            # (sharded 1x1's chunked rerun, ~33 s, went for phase 11: the
            # sharded engine's chunked driver is held by 2x5 here and by
            # scale_u256 3x5, fig2_drop50 2x4 and scale_u65536 1x1)
            one = first_seed(res)
            chunked_rerun(label, lambda: make("chunked", True, 1), one,
                          fig3_want(one))
        fig3_on_card[label] = res
    for label in ("fig3_cifar_fused sharded 1x1 u_sharded",
                  "fig3_cifar_fused sharded 2x5 u_sharded"):
        log({"phase": "sharded_vs_single", "run": label,
             "what": "final state and metrics, sharded vs single engine, "
                     "both on the card (the CNN's users take their "
                     "gradients one at a time on every engine and mesh)",
             **bitwise_runs(fig3_on_card["fig3_cifar_fused"],
                            fig3_on_card[label])})
    # the CNN's seeds as one vmapped program through the chunked driver
    # (one graph for both seeds; each user's gradient a grouped
    # convolution over the seeds), held to the map run on the card by
    # the update off the conv biases, by its norm, as phase 5 holds
    # Adam (Adam turns the conv biases' rounding noise into steps of up
    # to lr, so the accuracy gap is logged)
    from repro_torch import prng as _prng
    from repro_torch.sim.scenario import TASKS
    res = chunked_launches(
        "fig3_cifar_fused vmap chunked", lambda: SweepRunner(
            [fig3_fused], seeds=FIG3_VMAP_SEEDS, device="cuda",
            keep_state=True, driver="chunked", warmup=True).run()[0],
        {"fused_mac": 2 * FIG3_ROUNDS})
    map_res = fig3_on_card["fig3_cifar_fused"]
    inits = [TASKS["cifar"][0](_prng.PRNGKey(s)) for s in res.seeds]
    from repro_torch.tree import tree_map as _tree_map
    theta0 = _tree_map(lambda *xs: torch.stack(xs), *inits)
    map_cpu = dataclasses.replace(map_res, final_state={
        "theta": _tree_map(lambda t: t.cpu(), map_res.final_state["theta"])})
    gaps = {**compare_runs(res, map_res),
            **theta_gaps(res, map_cpu, theta0, fig3_fused.lr)}
    log({"phase": "vmap_vs_map", "run": "fig3_cifar_fused vmap chunked",
         "seeds": res.seeds, "batch": res.exec_info["batch"],
         "dispatches": res.exec_info["dispatches"], **gaps,
         "rounds_per_sec": res.rounds[-1] / res.exec_info["drive_seconds"],
         "bound_update_rel": FIG3_ADAM_UPDATE_RTOL})
    if not (res.exec_info["batch"] == "vmap" and finite(res)
            and gaps["update_rel_gap_off_conv_biases_and_partners"]
            <= FIG3_ADAM_UPDATE_RTOL):
        raise SystemExit(f"fig3 under vmap disagrees with its map run: "
                         f"{gaps}")
    # phase 6 reads peak device memory: free the Fig. 3 runs' states
    del fig3_on_card, res, map_res, map_cpu
    # max_pool2d's backward under PyTorch's deterministic-algorithms
    # mode (the runners set only cuDNN's flags): accepted or refused
    from repro_torch import prng as _prng
    from repro_torch.sim.scenario import TASKS
    torch.use_deterministic_algorithms(True)
    try:
        p0 = TASKS["cifar"][0](_prng.PRNGKey(0, dev))
        xb = torch.zeros((fig3.batch, 32, 32, 3), device=dev)
        yb = torch.zeros((fig3.batch,), dtype=torch.int32, device=dev)
        torch.func.grad(TASKS["cifar"][2])(p0, xb, yb, _prng.PRNGKey(1, dev))
        torch.cuda.synchronize()
        verdict = "accepted"
    except RuntimeError as e:
        verdict = f"refused: {str(e)[:200]}"
    finally:
        torch.use_deterministic_algorithms(False)
    log({"phase": "main_path", "what": "the CNN's gradient (max_pool2d "
         "backward) under torch.use_deterministic_algorithms(True)",
         "verdict": verdict})

    spec = importlib.util.spec_from_file_location(
        "whfl_mnist_torch", ROOT / "examples" / "whfl_mnist_torch.py")
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    argv = ["--ota", "faithful", "--backend", "slab_kernel", "--IT", "8",
            "--seeds", "2"]
    doc, launches = counted(lambda: driver.main(argv))
    for rec in doc["scenarios"]:
        r = rec["rounds"][-1]
        log({"phase": "main_path", "run": "fig2_driver_slab",
             "argv": argv, "scenario": rec["scenario"]["name"],
             "ota": f"{rec['scenario']['ota_mode']}/"
                    f"{rec['scenario']['ota_backend']}",
             "seeds": rec["seeds"], "rounds": r,
             "rounds_per_sec": r / rec["exec"]["drive_seconds"],
             "final_acc": [a[-1] for a in rec["metrics"]["acc"]]})
    # the driver runs its 2 seeds as one vmapped program: 46 launches,
    # each for both seeds (92 when seeds ran one by one)
    want = expected_slab_launches(doc)
    if want != 46 or {rec["exec"]["batch"] for rec in doc["scenarios"]} \
            != {"vmap"}:
        raise SystemExit(f"the Fig. 2 driver's schemes imply {want} "
                         f"ota_combine launches, not 46 under vmap")
    expect("fig2_driver_slab", launches,
           {"fused_mac": 0, "ota_combine": want},
           all(np.all(np.isfinite(np.asarray(rec["metrics"][k], np.float64)))
               for rec in doc["scenarios"] for k in rec["metrics"]))

    res, launches = counted(lambda: SweepRunner(
        [fig2_ref], seeds=2, quick=True, device="cuda", batch="map").run()[0])
    log({"phase": "main_path", "run": "fig2_iid_reference_quick",
         "ota": "faithful/reference", "seeds": res.seeds,
         "rounds": res.rounds[-1],
         "final_acc": [a[-1] for a in res.acc]})
    expect("fig2_iid_reference_quick", launches,
           {"fused_mac": 0, "ota_combine": 0}, finite(res))

    # partial participation and the robust folds: fig2's participation
    # family at the paper's sizes (C 4, M 5, K = K_ps = 100), cut to 5
    # rounds, 2 seeds; the fused and slab hops take the precoded users,
    # the median fold the orthogonal per-user hop of the equivalent
    # backend (no kernel of ours).  Each run's realised masks, computed
    # on the card from a device round index as the round computes them,
    # against the CPU's
    part_runs = [
        ("fig2_drop50_fused", drop50_fused, "fused_mac"),
        ("fig2_byzantine3_fused", get_scenario("fig2_byzantine3").replace(
            total_IT=5, ota_mode="faithful", ota_backend="fused"),
         "fused_mac"),
        ("fig2_straggler_slab", get_scenario("fig2_straggler").replace(
            total_IT=5, ota_mode="faithful", ota_backend="slab_kernel"),
         "ota_combine"),
        ("fig2_byzantine1_median", byz1_median, None)]
    part_on_card = {}
    for label, sc, kernel in part_runs:
        make = lambda driver="stepwise", warmup=False, sc=sc: SweepRunner(
            [sc], seeds=2, device="cuda", keep_state=True, driver=driver,
            warmup=warmup, batch="map")
        res, launches = counted(lambda: make().run()[0])
        rounds = res.rounds[-1]
        sched = sc.participation_schedule()
        masks = {d: sched.history(rounds, sc.C, sc.M, device=d)
                 for d in ("cuda", "cpu")}
        same_masks = masks["cuda"].tobytes() == masks["cpu"].tobytes()
        log({"phase": "main_path", "run": label, "scenario": sc.name,
             "C": sc.C, "M": sc.M, "K": sc.K, "K_ps": sc.K_ps,
             "ota": ota_label(sc), "cluster_agg": sc.cluster_agg,
             "participation": sc.participation, "n_byzantine":
             sc.n_byzantine, "seeds": res.seeds, "rounds": rounds,
             "attendance": float(masks["cpu"].mean()),
             "masks_card_equal_cpu": same_masks,
             "rounds_per_sec": rounds / res.exec_info["drive_seconds"],
             "final_acc": [a[-1] for a in res.acc],
             "final_loss": [v[-1] for v in res.loss]})
        if not same_masks:
            raise SystemExit(f"{label}: the card's realised masks differ "
                             f"from the CPU's")
        # one cluster hop and one IS->PS hop per round and seed
        want = ({kernel: rounds * (sc.I + 1) * len(res.seeds)} if kernel
                else {})
        expect(label, launches, want, finite(res))
        chunked_rerun(label, lambda: make("chunked", True), res, want)
        part_on_card[label] = res
    # the fused participation run on the sharded engine, u_sharded, on
    # 1x1 and on 2x4 (M 5 padded to 8): the partial kernels take the
    # precoded tiles, and the run equals the single engine's bit for bit
    # (every engine's gradients run in passes of M users); the 2x4
    # cluster hop itself, on precoded deltas, equals the single engine's
    # bit for bit
    for mesh in ("1x1", "2x4"):
        mc, mu = parse_mesh(mesh)
        make = (lambda driver="stepwise", warmup=False, mesh=mesh:
                ShardedSweepRunner([drop50_fused], seeds=2, mesh=mesh,
                                   combine="u_sharded", device="cuda",
                                   keep_state=True, driver=driver,
                                   warmup=warmup))
        res, launches = counted(lambda: make().run()[0])
        label = f"fig2_drop50_fused sharded {mesh} u_sharded"
        hops = res.rounds[-1] * len(res.seeds)
        want = {"fused_mac_partials": hops * mc * mu,
                "fused_partials_reduce": hops * mu, "fused_mac": hops}
        single_res = part_on_card["fig2_drop50_fused"]
        same = bitwise_runs(single_res, res)
        gaps = compare_runs(res, single_res)
        rec = {"phase": "sharded_vs_single", "run": label,
               "what": "final state and metrics, sharded vs single "
                       "engine, both on the card", "exec": res.exec_info,
               **same, **gaps}
        ok = same["state_bitwise_equal"] and same["metrics_bitwise_equal"]
        log(rec)
        expect(label, launches, want, finite(res))
        if not ok:
            raise SystemExit(f"{label}: the sharded run differs from the "
                             f"single engine's: {same}, {gaps}")
        chunked_rerun(label, lambda: make("chunked", True), res, want)
    from repro_torch import prng
    topo2 = fig2.make_topology()
    g = torch.Generator(device=dev).manual_seed(66)
    deltas = (1e-2 * torch.randn(fig2.C, fig2.M, 7850, generator=g,
                                 device=dev)
              * mult.to(dev).reshape(fig2.C, fig2.M, 1))
    key, P = prng.PRNGKey(66, dev), torch.tensor(0.5, device=dev)
    ota2 = drop50_fused.whfl_config().ota
    want_est = channel.cluster_ota(key, deltas, topo2, P, ota2)
    got_est = make_fused_cluster_hop(topo2, ota2, make_device_mesh("2x4", dev),
                                     3925, "u_sharded")(key, deltas, P)
    same_hop = torch.equal(got_est[:fig2.C], want_est)
    log({"phase": "sharded_vs_single", "run": "fig2 cluster hop precoded, "
         "2x4 u_sharded vs fused", "bitwise_equal": same_hop,
         "max_abs_gap": float((got_est[:fig2.C] - want_est).abs().max())})
    if not same_hop:
        raise SystemExit("the 2x4 u_sharded cluster hop on precoded users "
                         "differs from the single engine's")
    # seed batching (``batch="vmap"``, the sweep's default): each run's
    # seeds as one program, the OTA kernel launched once a hop for all
    # of them, through both drivers (chunked == stepwise bit for bit, one
    # graph for all seeds); every seed within the W-HFL bounds of its own
    # map run on the card
    vmap_runs = [
        ("fig2_iid_fused", fig2_fused, S_SEEDS, "fused_mac", None),
        ("fig2_iid_slab", fig2_slab, S_SEEDS, "ota_combine", None),
        ("fig2_drop50_fused", drop50_fused, 2, "fused_mac",
         part_on_card["fig2_drop50_fused"]),
        ("scale_u256", u256, 2, "fused_mac", u256_on_card)]
    for label, sc, S, kernel, map_res in vmap_runs:
        make = (lambda driver="stepwise", warmup=False, sc=sc, S=S:
                SweepRunner([sc], seeds=S, device="cuda", keep_state=True,
                            driver=driver, warmup=warmup))
        res, launches = counted(lambda: make().run()[0])
        rounds = res.rounds[-1]
        if map_res is None:
            map_res = SweepRunner([sc], seeds=S, device="cuda",
                                  keep_state=True, batch="map").run()[0]
        gaps = compare_runs(res, map_res)
        log({"phase": "vmap_vs_map", "run": f"{label} vmap S={S}",
             "scenario": sc.name, "ota": ota_label(sc), "seeds": res.seeds,
             "rounds": rounds, "batch": res.exec_info["batch"],
             "dispatches": res.exec_info["dispatches"], **gaps,
             "rounds_per_sec": rounds / res.exec_info["drive_seconds"],
             "rounds_per_sec_map": rounds
             / map_res.exec_info["drive_seconds"]})
        # one cluster hop and one IS->PS hop a round, for all seeds
        want = {kernel: rounds * (sc.I + 1)}
        expect(f"{label} vmap S={S}", launches, want,
               finite(res) and res.exec_info["batch"] == "vmap")
        if not (gaps["loss_max_rel"] <= TOL
                and gaps["acc_max_abs"] <= 2.0 / sc.n_test
                and gaps["theta_max_rel"] <= THETA_RTOL):
            raise SystemExit(f"{label} under vmap disagrees with its map "
                             f"run: {gaps}")
        chunked_rerun(f"{label} vmap S={S}", lambda: make("chunked", True),
                      res, want)
    del part_on_card, res, deltas, want_est, got_est, map_res

    # the sharded engine through the sweep CLI
    u256_one_process = {}       # phase 12's references
    sharded_runs = [("scale_u256", "1x1", "u_sharded", 2),
                    ("scale_u256", "2x4", "u_sharded", 2),
                    ("scale_u256", "3x5", "u_sharded", 2),    # 6x65 padded
                    ("scale_u256", "2x4", "gathered", 2),
                    ("scale_u16384", "1x1", "u_sharded", 1),
                    ("scale_u16384", "1x1", "gathered", 1),
                    ("scale_u65536", "1x1", "u_sharded", 1)]
    for name, mesh, combine, seeds in sharded_runs:
        label = f"{name} {mesh} {combine}"
        argv = ["--scenarios", name, "--seeds", str(seeds), "--exec",
                "sharded", "--mesh", mesh, "--combine", combine]
        torch.cuda.reset_peak_memory_stats()
        doc, launches = counted(lambda: sweep.main(argv))
        peak = torch.cuda.max_memory_allocated()
        rec = doc["scenarios"][0]
        rounds, I = rec["rounds"][-1], rec["scenario"]["I"]
        hops = rounds * len(rec["seeds"])          # rounds x seeds
        mc, mu = parse_mesh(mesh)
        want = ({"fused_mac_partials": hops * I * mc * mu,
                 "fused_partials_reduce": hops * I * mu, "fused_mac": hops}
                if combine == "u_sharded" else
                {"fused_mac": hops * (I * mc * mu + 1)})
        log({"phase": "main_path", "run": f"sharded {label}",
             "argv": argv, "exec": rec["exec"], "seeds": rec["seeds"],
             "rounds": rounds,
             "rounds_per_sec": rounds / rec["exec"]["drive_seconds"],
             "max_memory_allocated_bytes": peak,
             "final_acc": [a[-1] for a in rec["metrics"]["acc"]],
             "final_loss": [v[-1] for v in rec["metrics"]["loss"]]})
        expect(f"sharded {label}", launches, want, bool(all(
            np.all(np.isfinite(np.asarray(v, np.float64)))
            for v in rec["metrics"].values())))
        # the same CLI run through the chunked driver: the same metrics
        # bit for bit and the same launches, in a trace of its drive
        # (peak memory with the smoke's tensors held; the graphs' pool
        # holds a round's buffers beside the carry)
        argv_c = argv + ["--driver", "chunked", "--warmup"]
        torch.cuda.reset_peak_memory_stats()
        doc_c = chunked_launches(f"sharded {label} chunked",
                                 lambda: sweep.main(argv_c), want)
        rec_c = doc_c["scenarios"][0]
        same = rec_c["metrics"] == rec["metrics"]
        log({"phase": "chunked_vs_stepwise", "run": f"sharded {label}",
             "max_memory_allocated_bytes_chunked":
                 torch.cuda.max_memory_allocated(),
             "argv": argv_c, "metrics_bitwise_equal": same,
             "dispatches": rec_c["exec"]["dispatches"],
             "rounds_per_sec_chunked": rounds
             / rec_c["exec"]["drive_seconds"],
             "rounds_per_sec_stepwise": rounds
             / rec["exec"]["drive_seconds"]})
        if not same:
            raise SystemExit(f"sharded {label}: the chunked driver's "
                             f"metrics differ from the stepwise ones")
        if name != "scale_u256":
            continue
        # the same run with its final state, against the single engine
        res = ShardedSweepRunner([u256], seeds=2, mesh=mesh,
                                 combine=combine, keep_state=True,
                                 device="cuda").run()[0]
        if (mesh, combine) == ("2x4", "u_sharded"):
            u256_sharded_on_card = res
        u256_one_process[name, mesh, combine] = res
        theta = u256_on_card.final_state["theta"]
        gap = max(float((res.final_state["theta"][k] - theta[k]).abs()
                        .max()) for k in theta)
        log({"phase": "sharded_vs_single", "run": label,
             "what": "final model and metrics, sharded vs single engine, "
                     "both on the card",
             "theta_bitwise_equal": all(
                 torch.equal(res.final_state["theta"][k], theta[k])
                 for k in theta),
             "metrics_bitwise_equal": all(
                 getattr(res, k) == getattr(u256_on_card, k)
                 for k in ("acc", "loss", "edge_power", "is_power")),
             "theta_max_abs_gap": gap,
             "theta_max_rel_gap": gap / max(float(theta[k].abs().max())
                                            for k in theta)})

    # -- the sweep's telemetry, guard, faults and checkpoints ---------------
    # (queue A items 9 and 10) at fig2's full width: fig2_iid fused at the
    # paper's sizes (C 4, M 5, K = K_ps = 100, batch 500, n_train 20,000),
    # 5 rounds, 2 seeds, against phase 4's plain stepwise run of it
    from repro_torch.ft import CRASH_EXIT_CODE, FaultPlan
    from repro_torch.obs import telemetry as tele_mod

    fused_want = lambda res: {"fused_mac": 2 * res.rounds[-1]
                              * len(res.seeds)}
    tele_card = {}
    for driver in ("stepwise", "chunked"):
        label = f"fig2_iid_fused telemetry+guard {driver}"
        make = (lambda driver=driver: SweepRunner(
            [fig2_fused], seeds=2, device="cuda", keep_state=True,
            driver=driver, warmup=driver == "chunked", telemetry=True,
            guard="skip_round", batch="map"))
        if driver == "stepwise":
            res, launches = counted(lambda: make().run()[0])
            expect(label, launches, fused_want(res), finite(res))
        else:
            res = chunked_launches(label, lambda: make().run()[0],
                                   {"fused_mac": 2 * fig2_fused.rounds * 2})
        same = bitwise_runs(fig2_fused_on_card, without_blocks(res))
        tele = res.to_record()["telemetry"]
        tele_ok = all(np.isfinite(np.asarray(tele[k], np.float64)).all()
                      for k in tele_mod.TELEMETRY_KEYS)
        log({"phase": "telemetry_guard", "run": label,
             "what": "telemetry and the guard (skip_round, no fault) on, "
                     "against the plain stepwise run", **same,
             "guard_trips": res.exec_info["guard_trips"],
             "telemetry_finite": tele_ok,
             "snr_round1": tele["snr"][0][0],
             "grad_ratio_round1": tele["grad_ratio"][0][0]})
        if not (same["state_bitwise_equal"] and same["metrics_bitwise_equal"]
                and tele_ok and res.exec_info["guard_trips"] == 0):
            raise SystemExit(f"{label}: telemetry or the guard changed the "
                             f"run: {same}")
        tele_card[driver] = tele
    if tele_card["stepwise"] != tele_card["chunked"]:
        raise SystemExit("the chunked driver's telemetry differs from the "
                         "stepwise one's")
    # the card's telemetry against the CPU's (its first 2 rounds, seed 0)
    tele_cpu, cpu_s = cpu_result("fig2_iid_fused telemetry")
    tele_cpu = tele_cpu.telemetry
    gaps = {k: float(np.max(np.abs(
                np.asarray(tele_card["stepwise"][k][0][:2], np.float64)
                - np.asarray(tele_cpu[k][0], np.float64)))
            / max(float(np.max(np.abs(np.asarray(tele_cpu[k][0],
                                                 np.float64)))), 1e-30))
            for k in tele_mod.TELEMETRY_KEYS}
    log({"phase": "reference", "run": "fig2_iid_fused telemetry",
         "what": "the card's telemetry block (2 rounds, seed 0) against "
                 "the CPU's, max gap over max |value| per field",
         "gaps": gaps, "bound": TOL, "cpu_seconds": cpu_s})
    if max(gaps.values()) > TOL:
        raise SystemExit(f"the card's telemetry disagrees with the CPU's: "
                         f"{gaps}")

    # a NaN in user (0, 1)'s delta at round index 2: zero_fill keeps the
    # run finite with one trip a seed (the cluster hop's), through both
    # drivers alike; halt stops at the window ending round 3
    poison = FaultPlan.parse("poison=nan@2:0:1")
    for guard in ("zero_fill", "halt"):
        poisoned = {}
        for driver in ("stepwise", "chunked"):
            label = f"fig2_iid_fused poison=nan@2:0:1 {guard} {driver}"
            res, launches = counted(lambda: SweepRunner(
                [fig2_fused], seeds=2, device="cuda", keep_state=True,
                driver=driver, guard=guard, faults=poison,
                batch="map").run()[0])
            info = res.exec_info
            ok = (finite(res) and info["guard_trips"] == 2
                  and info["guard_halted"] == (guard == "halt")
                  and res.rounds == ([1, 2, 3] if guard == "halt"
                                     else list(range(1, 6))))
            log({"phase": "guard", "run": label, "rounds": res.rounds,
                 "guard_trips": info["guard_trips"],
                 "guard_halted": info["guard_halted"], "finite": finite(res),
                 "final_loss": [v[-1] for v in res.loss]})
            if driver == "stepwise":
                expect(label, launches, fused_want(res), ok)
            elif not ok:
                raise SystemExit(f"{label}: {info}")
            poisoned[driver] = res
        same = bitwise_runs(poisoned["stepwise"], poisoned["chunked"])
        log({"phase": "chunked_vs_stepwise",
             "run": f"fig2_iid_fused poison {guard}", **same})
        if not (same["state_bitwise_equal"]
                and same["metrics_bitwise_equal"]):
            raise SystemExit(f"poison {guard}: chunked != stepwise: {same}")

    # a process killed after round 3 (exit 173), then resumed from its
    # checkpoint in a new process: the whole carry and every metric
    # equal the uninterrupted run's (the chunked resume captures its
    # graphs afresh), for both drivers in both seed modes
    # (each step's four runs side by side, in four processes)
    modes = [(d, b) for d in ("stepwise", "chunked") for b in ("map", "vmap")]
    cks = {m: tempfile.mkdtemp(prefix=f"ck_{m[0]}_{m[1]}_") for m in modes}
    rcs, secs = defaultdict(dict), defaultdict(dict)
    for step, extra in (("crash", {"inject": "crash_round=3"}),
                        ("resume", {"resume": True})):
        t0 = time.perf_counter()
        procs = {m: subprocess.Popen(
            [sys.executable, "-c", RESUME_SNIPPET, json.dumps(
                {"driver": m[0], "batch": m[1], "ckpt": cks[m], **extra,
                 "out": str(Path(cks[m]) / f"{step}.json")})],
            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for m in modes}
        for m, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            rcs[m][step] = proc.returncode
            secs[m][step] = time.perf_counter() - t0
            if proc.returncode not in (0, CRASH_EXIT_CODE):
                print(err[-3000:], file=sys.stderr)
    for driver, batch in modes:
        ref = SweepRunner([fig2_fused], seeds=2, device="cuda",
                          keep_state=True, driver=driver,
                          batch=batch).run()
        m = (driver, batch)
        out = Path(cks[m]) / "resume.json"
        outs = json.load(open(out)) if rcs[m]["resume"] == 0 else {}
        want_state = sweep.state_doc(ref)["scenarios"][0]["state"]
        want_doc = sweep.sweep_to_json(ref)["scenarios"][0]
        ok = (rcs[m] == {"crash": CRASH_EXIT_CODE, "resume": 0}
              and outs.get("state") == want_state
              and outs.get("metrics") == want_doc["metrics"]
              and outs.get("resumed_from") == 3)
        log({"phase": "kill_and_resume",
             "run": f"fig2_iid_fused {driver} {batch}",
             "exit_codes": rcs[m], "seconds": secs[m],
             "resumed_from": outs.get("resumed_from"),
             "ckpt_save_seconds": outs.get("ckpt_save_seconds"),
             "ckpt_load_seconds": outs.get("ckpt_load_seconds"),
             "state_bitwise_equal": outs.get("state") == want_state,
             "metrics_bitwise_equal": outs.get("metrics")
             == want_doc["metrics"]})
        if not ok:
            raise SystemExit(f"kill and resume ({driver}, {batch}): "
                             f"{rcs[m]}")
        shutil.rmtree(cks[m], ignore_errors=True)

    # scale_u256 sharded 2x4 u_sharded with telemetry: bit for bit the
    # single engine's run with telemetry (the block on the real C)
    u_tele = SweepRunner([u256], seeds=2, device="cuda", keep_state=True,
                         telemetry=True, batch="map").run()[0]
    res, launches = counted(lambda: ShardedSweepRunner(
        [u256], seeds=2, mesh="2x4", combine="u_sharded", device="cuda",
        keep_state=True, telemetry=True).run()[0])
    hops = res.rounds[-1] * len(res.seeds) * u256.I
    expect("scale_u256 sharded 2x4 u_sharded telemetry", launches,
           {"fused_mac_partials": hops * 8, "fused_partials_reduce":
            hops * 4, "fused_mac": res.rounds[-1] * len(res.seeds)},
           finite(res))
    same = bitwise_runs(u_tele, res)
    same_tele = (u_tele.to_record()["telemetry"]
                 == res.to_record()["telemetry"])
    log({"phase": "sharded_vs_single", "run": "scale_u256 2x4 u_sharded "
         "telemetry", **same, "telemetry_equal": same_tele})
    if not (same["state_bitwise_equal"] and same["metrics_bitwise_equal"]
            and same_tele):
        raise SystemExit("scale_u256 2x4 with telemetry != single")

    # the slab kernel with telemetry, against the plain slab run
    slab3 = fig2_slab.replace(total_IT=3)
    slab_plain = SweepRunner([slab3], seeds=2, device="cuda",
                             keep_state=True, batch="map").run()[0]
    res, launches = counted(lambda: SweepRunner(
        [slab3], seeds=2, device="cuda", keep_state=True,
        telemetry=True, batch="map").run()[0])
    expect("fig2_iid_slab telemetry", launches,
           {"ota_combine": 2 * res.rounds[-1] * 2}, finite(res))
    same = bitwise_runs(slab_plain, without_blocks(res))
    log({"phase": "telemetry_guard", "run": "fig2_iid_slab telemetry",
         **same})
    if not (same["state_bitwise_equal"] and same["metrics_bitwise_equal"]):
        raise SystemExit("fig2 slab: telemetry changed the run")

    # --profile: the CLI's Chrome trace holds fused_mac's device records
    # (a trace that lost some is taken again)
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        pdir = tempfile.mkdtemp(prefix="prof_")
        doc, launches = counted(lambda: sweep.main(
            ["--scenarios", "scale_u256", "--seeds", "1", "--profile",
             pdir]))
        events = json.load(open(Path(pdir) / "trace.json"))["traceEvents"]
        seen = sum(KERNELS["fused_mac"][1] in e.get("name", "")
                   for e in events if e.get("cat") == "kernel")
        log({"phase": "profile_cli", "run": "scale_u256 --profile",
             "fused_mac_records": seen,
             "fused_mac_launches": launches["fused_mac"],
             "trace_attempt": attempt})
        shutil.rmtree(pdir, ignore_errors=True)
        if seen >= launches["fused_mac"] > 0:
            break
    if not seen >= launches["fused_mac"] > 0:
        raise SystemExit(f"--profile: {seen} fused_mac records in the "
                         f"trace, {launches['fused_mac']} launches")

    # the repaired gate: fig2_iid fused at batch 500 on 2x4, 2x5 and 4x5
    # bit for bit the single engine (every engine's gradients in passes
    # of M users)
    for mesh in ("2x4", "2x5", "4x5"):
        mc, mu = parse_mesh(mesh)
        res, launches = counted(lambda: ShardedSweepRunner(
            [fig2_fused], seeds=2, mesh=mesh, combine="u_sharded",
            device="cuda", keep_state=True).run()[0])
        hops = res.rounds[-1] * len(res.seeds)
        label = f"fig2_iid_fused sharded {mesh} u_sharded"
        expect(label, launches, {"fused_mac_partials": hops * mc * mu,
                                 "fused_partials_reduce": hops * mu,
                                 "fused_mac": hops}, finite(res))
        same = bitwise_runs(fig2_fused_on_card, res)
        log({"phase": "sharded_vs_single", "run": label,
             "what": "fig2 at batch 500, sharded vs single, both on the "
                     "card", **same, **compare_runs(res, fig2_fused_on_card)})
        if not (same["state_bitwise_equal"]
                and same["metrics_bitwise_equal"]):
            raise SystemExit(f"{label}: differs from the single engine: "
                             f"{same}")
    del u_tele, slab_plain, res

    # dense-LM serving: qwen2-0.5b at full width, weights from a seed
    from repro_torch.configs import INPUT_SHAPES, get_config

    qwen = get_config(LM_ARCH)
    lm_run = serve_lm(
        qwen, dev, card, counted, expect,
        dataclasses.replace(INPUT_SHAPES["prefill_32k"], global_batch=4,
                            seq_len=4096),
        dataclasses.replace(INPUT_SHAPES["decode_32k"], global_batch=8),
        cuts={"prefill": "prefill_32k: batch 32 -> 4, length 32768 -> 4096",
              "decode": "decode_32k: batch 128 -> 8, cache 32768"})
    # a float32 prefill at hd 128 (qwen2-1.5b at full width, depth cut):
    # the tf32 kernel's hd-128 instance
    from repro_torch import prng
    from repro_torch.launch import serve
    from repro_torch.models import lm

    q15 = get_config(F32_HD128_ARCH)
    q15_f32 = q15.with_(n_layers=F32_HD128_LAYERS, compute_dtype="float32")
    params15 = lm.init_params(prng.PRNGKey(0, dev), q15_f32)
    log({"phase": "main_path", "run": f"{q15.name} init", "arch": q15.name,
         "n_layers": q15_f32.n_layers, "d_model": q15.d_model,
         "heads": q15.n_heads, "kv_heads": q15.n_kv_heads,
         "head_dim": q15.head_dim, "compute_dtype": "float32"})
    served15 = serve.compute_params(params15, q15_f32)
    q15_step, q15_batch = prefill_path(
        f"{q15.name} prefill f32", q15_f32, served15, "flash_mha_tf32",
        dataclasses.replace(INPUT_SHAPES["prefill_32k"], global_batch=1,
                            seq_len=4096),
        dev, counted, expect,
        f"prefill_32k: batch 32 -> 1, length 32768 -> 4096; "
        f"depth {q15.n_layers} -> {F32_HD128_LAYERS} layers")
    q15_tokens = q15_batch["tokens"]
    # the hd-32 instances' main path: the serving example's model
    # (examples/serve_decode_torch.py runs LM_ARCH's reduced() config,
    # head_dim 32), prefilled at qwen2-0.5b's prefill shape through the
    # same serving entry point, at its bf16 compute and at float32
    small = qwen.reduced()
    params_small = lm.init_params(prng.PRNGKey(0, dev), small)
    log({"phase": "main_path", "run": f"{small.name} reduced init",
         "n_layers": small.n_layers, "d_model": small.d_model,
         "heads": small.n_heads, "kv_heads": small.n_kv_heads,
         "head_dim": small.head_dim, "compute_dtype": small.compute_dtype})
    small_shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"],
                                      global_batch=4, seq_len=4096)
    small_runs = []          # (label, cfg, step, served params, tokens)
    for run_cfg, record, suffix in (
            (small, "flash_mha_wgmma", ""),
            (small.with_(compute_dtype="float32"), "flash_mha_tf32", " f32")):
        served_p = serve.compute_params(params_small, run_cfg)
        label = f"{small.name} reduced prefill{suffix}"
        step, batch = prefill_path(
            label, run_cfg, served_p, record, small_shape, dev, counted,
            expect, "the serving example's reduced() config; prefill_32k: "
            "batch 32 -> 4, length 32768 -> 4096")
        small_runs.append((label, run_cfg, step, served_p, batch["tokens"]))
    del params15
    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch", ROOT / "examples" / "serve_decode_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    res, launches = counted(lambda: example.main([]))
    log({"phase": "main_path", "run": "serve_decode_torch example",
         "argv": [], "tokens_shape": list(res["tokens"].shape),
         "prefill_ms_per_token": res["prefill_ms_per_token"],
         "decode_ms_per_token": res["decode_ms_per_token"]})
    expect("serve_decode_torch example", launches, {},
           bool(torch.isfinite(res["logits"]).all()))

    # -- phase 5: the main paths' output against a reference ---------------
    # fig2_iid as registered (no kernel) is the control: Adam turns any
    # difference between the card's and the CPU's arithmetic into a
    # larger gap in the model than SGD does
    # each run takes 2 seeds on both sides (the CPU side ran in the
    # processes started before phase 4); scale_u256's are phase 4's
    single = lambda sc: SweepRunner([sc], seeds=2, device="cuda",
                                    keep_state=True, batch="map").run()[0]
    for label, sc, card_res in (
            ("scale_u256", u256, u256_on_card),
            ("scale_u256 sharded 2x4 u_sharded", u256, u256_sharded_on_card),
            ("fig2_iid_slab", fig2_slab.replace(total_IT=1), None),
            ("fig2_iid_reference", fig2_ref.replace(total_IT=1), None),
            ("fig2_iid", fig2.replace(total_IT=2), None),
            ("fig2_drop50_fused", drop50_fused.replace(total_IT=2), None),
            ("fig2_byzantine1_median", byz1_median.replace(total_IT=2),
             None)):
        if card_res is None:
            card_res = single(sc)
        cpu_res, cpu_s = cpu_result(label)
        gaps = compare_runs(card_res, cpu_res)
        log({"phase": "reference", "run": label, "scenario": sc.name,
             "ota": ota_label(sc),
             "what": "the card (kernels) vs the CPU (plain versions)",
             "seeds": cpu_res.seeds, "rounds": cpu_res.rounds[-1], **gaps,
             "n_test": sc.n_test, "cpu_seconds": cpu_s})
        if not (gaps["loss_max_rel"] <= TOL
                and gaps["acc_max_abs"] <= 2.0 / sc.n_test
                and gaps["theta_max_rel"] <= THETA_RTOL):
            raise SystemExit(f"{label}: the card's run disagrees with the "
                             f"CPU reference")

    # Fig. 3, 1 round, card vs CPU.  The CPU's plain fused combine draws
    # every channel of both hops in int64 torch ops (1.2e9 draws at C 4,
    # M 5 take minutes), so the users and the batch are cut: C 4 -> 2,
    # M 5 -> 2, batch 128 -> 32; K = K_ps = 100 and the model stay.
    # - faithful/fused with SGD: every bound of the fig2 runs;
    # - the registered Adam on the error-free channel (fig3_cifar_ideal),
    #   where nothing couples coordinates: accuracy, every entry within
    #   2 lr per local step, and the update off the conv biases within
    #   FIG3_ADAM_UPDATE_RTOL of its size (see there);
    # - faithful/fused with Adam, as registered: accuracy; the OTA hops
    #   carry the conv biases' noise steps into the coordinates packed
    #   with them, so the loss and model gaps are logged, also off those
    #   coordinates (ROADMAP queue C)
    from repro_torch import prng
    from repro_torch.optim import adam
    from repro_torch.sim.scenario import TASKS
    from repro_torch.tree import tree_leaves, tree_map

    for label, sc, gate in (
            ("fig3_cifar_fused sgd", fig3_fused.replace(opt="sgd",
                                                        **fig3_cut), "all"),
            ("fig3_cifar_ideal", get_scenario("fig3_cifar_ideal").replace(
                **fig3_cut), "adam"),
            ("fig3_cifar_fused", fig3_fused.replace(**fig3_cut), "acc")):
        card_res = SweepRunner([sc], seeds=1, device="cuda", keep_state=True,
                               batch="map").run()[0]
        cpu_res, cpu_s = cpu_result(label)
        theta0 = TASKS["cifar"][0](prng.PRNGKey(cpu_res.seeds[0]))
        gaps = {**compare_runs(card_res, cpu_res),
                **theta_gaps(card_res, cpu_res, theta0, sc.lr)}
        log({"phase": "reference", "run": label, "scenario": sc.name,
             "ota": ota_label(sc), "opt": sc.opt,
             "what": "the card (kernels, cuDNN) vs the CPU (plain "
                     "versions, oneDNN)",
             "cut": "C 4 -> 2, M 5 -> 2, batch 128 -> 32, 1 round",
             "seeds": cpu_res.seeds, "rounds": cpu_res.rounds[-1], **gaps,
             "gate": gate, "lr": sc.lr, "tau": sc.tau, "n_test": sc.n_test,
             "cpu_seconds": cpu_s})
        ok = gaps["acc_max_abs"] <= 2.0 / sc.n_test
        if gate == "all":
            ok &= (gaps["loss_max_rel"] <= TOL
                   and gaps["theta_max_rel"] <= THETA_RTOL)
        elif gate == "adam":
            ok &= (max(gaps["conv_bias_max_abs_gap"],
                       gaps["other_max_abs_gap"]) <= 2 * sc.lr * sc.tau
                   and gaps["update_rel_gap_off_conv_biases_and_partners"]
                   <= FIG3_ADAM_UPDATE_RTOL)
        if not ok:
            raise SystemExit(f"{label}: the card's run disagrees with the "
                             f"CPU reference")
    # Adam's step itself on the card against the CPU, on the same inputs:
    # the CNN's tree for fig3's 20 users, the second step (bias
    # corrections at t = 2), gradients spread over 8 decades so that
    # eps and the small-gradient ratios are exercised
    users = fig3.C * fig3.M
    rng = np.random.default_rng(94)
    th = tree_map(lambda x: x.expand(users, *x.shape).clone(),
                  TASKS["cifar"][0](prng.PRNGKey(95)))
    grads = [tree_map(lambda x: torch.as_tensor(
        (rng.standard_normal(x.shape)
         * 10.0 ** rng.uniform(-8, 0, x.shape)).astype(np.float32)), th)
        for _ in range(2)]
    steps = {}
    for device in ("cuda", "cpu"):
        opt, to = adam(fig3.lr), lambda t, d=device: t.to(d)
        p = tree_map(to, th)
        state = opt.init(p)
        for i, g in enumerate(grads):
            upd, state = opt.update(
                tree_map(to, g), state, p,
                torch.tensor(i, dtype=torch.int32, device=device))
        steps[device] = dict(tree_leaves([upd, state]))
    adam_gap = max(float((steps["cuda"][k].cpu() - v).abs().max()
                         / v.abs().max()) for k, v in steps["cpu"].items())
    log({"phase": "reference", "run": "adam step on the CNN's tree",
         "what": "the port's Adam, second step, card vs CPU on the same "
                 "gradients and state", "users": users,
         "max_rel_gap": adam_gap, "bound": ADAM_STEP_RTOL})
    if not adam_gap <= ADAM_STEP_RTOL:
        raise SystemExit("Adam's step on the card disagrees with the CPU")

    lm_reference(qwen, lm_run["params"], dev, prefill_len=256,
                 decode=(2, 64))
    small_vs_cpu(small_runs, params_small, small_shape)
    del params_small

    cpu_pool.shutdown()
    shutil.rmtree(cpu_dir, ignore_errors=True)
    if cpu_jobs:
        raise SystemExit(f"CPU runs started and never compared: "
                         f"{sorted(cpu_jobs)}")

    # -- phase 6: where the time goes --------------------------------------
    # the LM first: its weights are freed before the sharded runs' peak
    # device memory is read
    lm_profiles(lm_run, dev, card)
    for label, step, served_p, tokens in [
            (f"{q15.name} prefill f32 ({F32_HD128_LAYERS} layers) B1 L4096",
             q15_step, served15, q15_tokens)] + [
            (f"{label} B4 L4096", step, served_p, tokens)
            for label, _, step, served_p, tokens in small_runs]:
        def call(step=step, served_p=served_p, tokens=tokens):
            step(served_p, {"tokens": tokens})
            torch.cuda.synchronize()

        log({"phase": "profile", "run": label, "card": card,
             **lm_profile(call)})
    del served15, small_runs
    del lm_run
    # the reference backend issues ~60k ops a round (a 20-step fold per
    # hop), so it is profiled over 1 round (2 before phase 11, which cut it
    # for the run's time) to keep the trace small
    for label, sc in [(label, sc.replace(total_IT=1) if sc is fig2_ref
                       else sc) for label, sc, _ in runs] + [
            ("fig2_iid_slab", fig2_slab)]:
        prof = device_profile(SweepRunner([sc], seeds=1, device="cuda",
                                          batch="map"), sc)
        log({"phase": "profile", "run": label, "card": card, **prof})
    # participation: the mask, precode and rescale on the fused round,
    # through both drivers, over 2 rounds (for the run's time; the rates
    # are per round; the median fold's profiles, 23 s, went for phase 12,
    # PERF.md keeps the earlier ones)
    for label, sc in (("fig2_drop50 fused", drop50_fused.replace(
            total_IT=2)),):
        for d in ("stepwise", "chunked"):
            prof = device_profile(SweepRunner(
                [sc], seeds=1, device="cuda", driver=d,
                warmup=d == "chunked", batch="map"), sc)
            log({"phase": "profile", "run": f"{label} {d}", "card": card,
                 **prof})
    # (scale_u65536 1x1's profile, 29 s, went for phase 12; phase 4 logs
    # its peak memory through both drivers)
    for label, sc, mesh in (("sharded scale_u256 2x4 u_sharded", u256,
                             "2x4"),):
        torch.cuda.reset_peak_memory_stats()
        prof = device_profile(ShardedSweepRunner(
            [sc], seeds=1, mesh=mesh, combine="u_sharded", device="cuda"),
            sc)
        log({"phase": "profile", "run": label, "card": card,
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
             **prof})
    # Fig. 3's profiles (one round as registered and fused, stepwise, and
    # fused through the chunked driver's graph, 20 to 48 s each) went to
    # make way for phase 11; PERF.md keeps the earlier ones
    # rounds/s of both drivers, each warmed before its drive (fig3's
    # rates are phase 4's runs' and the profiles' above: its second pass
    # here makes way for phase 9)
    for label, make in (
            ("fig2_iid_fused", lambda d: SweepRunner(
                [fig2_fused], seeds=1, device="cuda", driver=d,
                warmup=True, batch="map")),
            ("scale_u256", lambda d: SweepRunner(
                [u256.replace(total_IT=10)], seeds=1, device="cuda",
                driver=d, warmup=True, batch="map")),
            ("sharded scale_u256 2x4 u_sharded", lambda d: ShardedSweepRunner(
                [u256.replace(total_IT=10)], seeds=1, mesh="2x4",
                combine="u_sharded", device="cuda", driver=d,
                warmup=True))):
        rates = {}
        for d in ("stepwise", "chunked"):
            r = make(d).run()[0]
            rates[d] = r.rounds[-1] / r.exec_info["drive_seconds"]
        log({"phase": "profile", "run": label, "what": "rounds/s per driver "
             "(1 seed, warmed)", "rounds": r.rounds[-1], "card": card,
             **{f"rounds_per_sec_{d}": v for d, v in rates.items()},
             "chunked_over_stepwise": rates["chunked"] / rates["stepwise"]})

    # -- phase 7: kernel times ---------------------------------------------
    timings = {}
    # (the plain version at fig3's cluster hop, 1.46 s a call, is timed
    # in one cold call)
    for label, (B, U, K, N), bu, p_reps in (
            ("scale_u256", (4, 256, 16, 3925), 64, 3),
            ("scale_u1024", (8, 1024, 16, 3925), 128, 3),
            ("fig3_cifar cluster", (4, 20, 100, 154197), 5, 1)):
        args = kernel_inputs(B, U, K, N, 7, dev)["args"]
        kw = dict(K=K, sigma_h2=1.0, sigma_z2=1.0, block_u=bu)
        ks, ps = in_turns(lambda: fused_mac(seed, *args, **kw),
                          lambda: fused_mac_plain(seed, *args, **kw), 20,
                          p_reps, warm_plain=p_reps > 1)
        bound, bound_by, issue = fused_mac_bound_ms(B, U, K, N,
                                                    cycles["fused_mac"])
        timings["fused_mac", label] = dict(
            ms=sum(ks) / 2, plain_ms=sum(ps) / len(ps), bound_ms=bound,
            bound_by=bound_by, shape_BUKN=[B, U, K, N])
        log({"phase": "times", "kernel": "fused_mac", "shape": label,
             "shape_BUKN": [B, U, K, N], "kernel_ms": ks, "plain_ms": ps,
             "bound_ms": bound, "bound_by": bound_by, "issue_ms": issue,
             "card": card})
        del args

    # a fig3 round by part, each timed alone at the round's shapes and
    # queued behind a spin (so the host's launch time hides): every
    # user's dropout masks for one local step (the int64 threefry
    # emulation), one user's gradient (the CNN's forward and backward at
    # batch 128), and Adam's update over all users' trees
    from repro_torch import prng
    from repro_torch.models import paper_models
    from repro_torch.optim import adam
    from repro_torch.sim.scenario import TASKS
    from repro_torch.tree import tree_leaves, tree_map

    users = fig3.C * fig3.M
    user_keys = prng.split(prng.PRNGKey(90, dev), users)
    p0 = TASKS["cifar"][0](prng.PRNGKey(91, dev))
    g = torch.Generator(device=dev).manual_seed(92)
    xb = torch.randn((fig3.batch, 32, 32, 3), generator=g, device=dev)
    yb = torch.randint(0, 10, (fig3.batch,), generator=g, device=dev)
    masks = tuple(m[0] for m in paper_models.dropout_masks(user_keys,
                                                            fig3.batch))
    grad = torch.func.grad(TASKS["cifar"][2])
    opt = adam(fig3.lr)
    th = tree_map(lambda x: x.expand(users, *x.shape).clone(), p0)
    opt_state, ones = opt.init(th), tree_map(torch.ones_like, th)
    step0 = torch.zeros((), dtype=torch.int32, device=dev)
    parts = {
        "masks_ms_per_step": queued_ms(
            lambda: paper_models.dropout_masks(user_keys, fig3.batch), 3),
        "grad_ms_per_user_step": queued_ms(
            lambda: grad(p0, xb, yb, masks), 2),
        "adam_ms_per_step": queued_ms(
            lambda: opt.update(ones, opt_state, th, step0), 3)}
    log({"phase": "times", "what": "fig3 round by part", "users": users,
         "tau": fig3.tau, "batch": fig3.batch, **parts,
         "parts_ms_per_round": fig3.tau * (
             parts["masks_ms_per_step"] + users
             * parts["grad_ms_per_user_step"] + parts["adam_ms_per_step"]),
         "card": card})
    # one local step's gradients of every user three ways: one user at a
    # time on fresh unbatched copies (the round's way, the loss's
    # ``per_user_grads``: the same shapes, so the same bits, on every
    # engine and mesh), all users in one vmapped pass, and vmapped chunks
    # of GRAD_CHUNK users; each one's gap to the round's way
    xu = torch.randn((users, fig3.batch, 32, 32, 3), generator=g, device=dev)
    yu = torch.randint(0, 10, (users, fig3.batch), generator=g, device=dev)
    args = [th, xu, yu, list(paper_models.dropout_masks(user_keys,
                                                        fig3.batch))]
    vgrad = torch.func.vmap(grad)

    def stacked(parts, join):
        return tree_map(lambda *xs: join(xs), *parts)

    ways = {
        "one_at_a_time": lambda: stacked(
            [grad(*tree_map(lambda a: a[u].clone(), args))
             for u in range(users)], torch.stack),
        "vmapped": lambda: vgrad(*args),
        f"chunks_of_{GRAD_CHUNK}": lambda: stacked(
            [vgrad(*tree_map(lambda a: a[u:u + GRAD_CHUNK].clone(), args))
             for u in range(0, users, GRAD_CHUNK)], torch.cat)}
    mine = dict(tree_leaves(ways["one_at_a_time"]()))
    for way, fn in ways.items():
        out = dict(tree_leaves(fn()))
        log({"phase": "times", "what": "fig3 gradients of every user, one "
             "local step", "way": way, "users": users, "batch": fig3.batch,
             "ms_per_step": queued_ms(fn, 2),
             "max_abs_gradient": max(float(v.abs().max())
                                     for v in mine.values()),
             "bitwise_equal_to_one_at_a_time": all(
                 torch.equal(out[k], mine[k]) for k in mine),
             "max_abs_gap_to_one_at_a_time": max(
                 float((out[k] - mine[k]).abs().max()) for k in mine),
             "card": card})
    del th, opt_state, ones, masks, xb, p0, xu, yu, args, mine, out

    cluster_fn = build.load("ota_combine").ota_combine_cluster_size
    cluster_fn.restype = ctypes.c_int
    cluster_fn.argtypes = [ctypes.c_int] * 3
    for label, sc, hop in (
            ("fig2_iid cluster", fig2_slab, "cluster"),
            ("fig2_iid conventional", fig2_slab.replace(mode="conventional"),
             "conventional"),                         # unbatched, as B = 1
            ("fig2_iid is_ps", fig2_slab, "is_ps"),   # unbatched, as B = 1
            ("scale_u256 cluster", u256_slab, "cluster")):
        args = slab_inputs(sc, hop, 40, dev)
        h = args[0]
        B, U, K, N = h.shape if h.dim() == 4 else (1, *h.shape)
        ks, ps = in_turns(lambda: ota_combine(*args),
                          lambda: ota_combine_plain(*args), 20, 5)
        bound, bound_by = ota_combine_bound_ms(B, U, K, N)
        timings["ota_combine", label] = dict(
            ms=sum(ks) / 2, plain_ms=sum(ps) / 2, bound_ms=bound,
            bound_by=bound_by, shape_BUKN=[B, U, K, N])
        log({"phase": "times", "kernel": "ota_combine", "shape": label,
             "shape_BUKN": [B, U, K, N],
             "cluster_blocks": cluster_fn(B, K, N), "kernel_ms": ks,
             "kernel_queued_ms": [queued_ms(lambda: ota_combine(*args), 20)
                                  for _ in range(2)],
             "plain_ms": ps, "bound_ms": bound, "bound_by": bound_by,
             "card": card})
        del args

    # seed batching: S_SEEDS seeds of fig2's hops in one launch against
    # S unbatched launches, in turns, beside S times one seed's bound and
    # the plain version with its seed axis
    S = S_SEEDS
    seeds_s = torch.tensor([[0xC0FFEE, 42 + s] for s in range(S)],
                           dtype=torch.int64, device=dev)
    for label, hop in (("fig2_iid cluster", "cluster"),
                       ("fig2_iid is_ps", "is_ps")):
        inps = [hop_inputs(fig2_fused, hop, 300 + s, dev) for s in range(S)]
        inp = inps[0]
        amp, w = inp["args"][2:]
        args = (seeds_s, *(torch.stack([x["args"][j] for x in inps])
                           for j in (0, 1)),
                amp.expand(S, *amp.shape), w.expand(S, *w.shape))
        kw = dict(K=inp["K"], sigma_h2=inp["sigma_h2"],
                  sigma_z2=inp["sigma_z2"], block_u=inp["block_u"])
        (B, U), K, N = amp.shape, inp["K"], args[1].shape[-1]
        ks, ls = in_turns(
            lambda: fused_mac(*args, **kw),
            lambda: [fused_mac(*(a[s] for a in args), **kw)
                     for s in range(S)], 20, 20)
        ps = [time_ms(lambda: fused_mac_plain(*args, **kw), 2)
              for _ in range(2)]
        bound, bound_by, issue = fused_mac_bound_ms(B, U, K, N,
                                                    cycles["fused_mac"])
        timings["fused_mac", f"{label} S={S}"] = dict(
            ms=sum(ks) / 2, plain_ms=sum(ps) / 2, bound_ms=S * bound,
            bound_by=bound_by, unbatched_launches_ms=sum(ls) / 2,
            shape_SBUKN=[S, B, U, K, N])
        log({"phase": "times", "kernel": "fused_mac",
             "shape": f"{label} S={S}", "shape_SBUKN": [S, B, U, K, N],
             "kernel_ms": ks, f"{S}_unbatched_launches_ms": ls,
             "plain_ms": ps, "bound_ms": S * bound, "bound_by": bound_by,
             "card": card})
        ops = [slab_inputs(fig2_slab, hop, 310 + s, dev) for s in range(S)]
        h, t, z = (torch.stack([o[j] for o in ops]) for j in range(3))
        w = ops[0][3]
        if h.dim() == 4:
            h, z, w = h[:, None], z[:, None], w[None]
        args = (h, t, z, w.expand(S, *w.shape))
        _, B, U, K, N = h.shape
        ks, ls = in_turns(
            lambda: ota_combine(*args),
            lambda: [ota_combine(*(a[s] for a in args)) for s in range(S)],
            20, 20)
        ps = [time_ms(lambda: ota_combine_plain(*args), 5) for _ in range(2)]
        bound, bound_by = ota_combine_bound_ms(B, U, K, N)
        timings["ota_combine", f"{label} S={S}"] = dict(
            ms=sum(ks) / 2, plain_ms=sum(ps) / 2, bound_ms=S * bound,
            bound_by=bound_by, unbatched_launches_ms=sum(ls) / 2,
            shape_SBUKN=[S, B, U, K, N])
        log({"phase": "times", "kernel": "ota_combine",
             "shape": f"{label} S={S}", "shape_SBUKN": [S, B, U, K, N],
             "cluster_blocks": cluster_fn(B, K, N), "kernel_ms": ks,
             f"{S}_unbatched_launches_ms": ls, "plain_ms": ps,
             "bound_ms": S * bound, "bound_by": bound_by, "card": card})
        del inps, args, ops, h, t, z

    # the two shapes phase 3 holds but earlier runs did not time:
    # fused_mac at Fig. 3's IS->PS hop and the partials at a tile of its
    # 2x5 mesh
    inp = hop_inputs(fig3_fused, "is_ps", 320, dev)
    args = inp["args"]
    (B, U), K, N = args[2].shape, inp["K"], args[0].shape[1]
    kw = dict(K=K, sigma_h2=inp["sigma_h2"], sigma_z2=inp["sigma_z2"],
              block_u=inp["block_u"])
    ks, ps = in_turns(lambda: fused_mac(seed, *args, **kw),
                      lambda: fused_mac_plain(seed, *args, **kw), 20, 2)
    bound, bound_by, issue = fused_mac_bound_ms(B, U, K, N,
                                                cycles["fused_mac"])
    timings["fused_mac", "fig3_cifar is_ps"] = dict(
        ms=sum(ks) / 2, plain_ms=sum(ps) / 2, bound_ms=bound,
        bound_by=bound_by, shape_BUKN=[B, U, K, N])
    log({"phase": "times", "kernel": "fused_mac", "shape": "fig3_cifar is_ps",
         "shape_BUKN": [B, U, K, N], "kernel_ms": ks, "plain_ms": ps,
         "bound_ms": bound, "bound_by": bound_by, "card": card})
    inp = tile_inputs(fig3_fused, (2, 5), 1, 3, 321, dev)
    args, (rb, ub, nb), bu = inp["args"], inp["bases"], inp["block_u"]
    (B, U), K, N = args[2].shape, inp["K"], args[0].shape[1]
    kw = dict(K=K, sigma_h2=inp["sigma_h2"], rx_base=rb, u_base=ub,
              n_base=nb, block_u=bu)
    ks, ps = in_turns(lambda: fused_mac_partials(seed, *args, **kw),
                      lambda: fused_mac_partials_plain(seed, *args, **kw),
                      20, 1)
    bound, bound_by, issue = partials_bound_ms(
        B, U, K, N, U // bu, cycles["fused_mac_partials"])
    timings["fused_mac_partials", "fig3_cifar 2x5 tile"] = dict(
        ms=sum(ks) / 2, plain_ms=sum(ps) / 2, bound_ms=bound,
        bound_by=bound_by, shape=[B, U, K, N])
    log({"phase": "times", "kernel": "fused_mac_partials",
         "shape": "fig3_cifar 2x5 tile", "shape_BUKN": [B, U, K, N],
         "block_u": bu, "kernel_ms": ks, "plain_ms": ps, "bound_ms": bound,
         "bound_by": bound_by, "card": card})
    del inp, args

    # the whole cluster hop at the scale_u256 shape: the slab backend
    # (emulated draw of the slab, then the combine) against the fused one
    from repro_torch import prng
    topo = u256.make_topology()
    g = torch.Generator().manual_seed(50)
    deltas = (1e-2 * torch.randn(topo.C, topo.M, 7850, generator=g)).to(dev)
    key = prng.PRNGKey(50, dev)
    P = torch.tensor(1.0)
    hop = {b: (lambda b=b: channel.cluster_ota(
        key, deltas, topo, P, channel.OTAConfig(backend=b)))
        for b in ("slab_kernel", "fused")}
    slab_ms, fused_ms = in_turns(hop["slab_kernel"], hop["fused"], 3, 20)
    log({"phase": "times", "what": "cluster hop, slab vs fused",
         "shape_BUKN": [topo.C, topo.C * topo.M, topo.K, 3925],
         "slab_hop_ms": slab_ms, "fused_hop_ms": fused_ms, "card": card})

    # the partial combine at its largest main-path shape, scale_u65536 on
    # a 1x1 mesh; its plain version takes ~20 s a call, so each turn of
    # it is one call, not warmed up, and the last turn's output is the
    # one both kernels are held to here
    inp = tile_inputs(u65536, (1, 1), 0, 0, 70, dev)
    args, bu = inp["args"], inp["block_u"]
    B, U = args[2].shape
    K, N = inp["K"], args[0].shape[1]
    G = U // bu
    kw = dict(K=K, sigma_h2=inp["sigma_h2"], block_u=bu)
    fold = dict(K=K, sigma_z2=inp["sigma_z2"])
    kept = {}

    def keep(key, fn):
        """fn(), with its output kept under `key` (the last call's)."""
        def run():
            kept[key] = fn()
        return run

    ks, ps = in_turns(
        lambda: fused_mac_partials(seed, *args, **kw),
        keep("partials", lambda: fused_mac_partials_plain(seed, *args,
                                                          **kw)),
        3, 1, warm_plain=False)
    p1 = fused_mac_partials(seed, *args, **kw)
    torch.cuda.synchronize()
    p2 = fused_mac_partials(seed, *args, **kw)
    rks, rps = in_turns(
        lambda: fused_partials_reduce(seed, *p1, **fold),
        keep("reduce", lambda: fused_partials_reduce_plain(seed, *p1,
                                                           **fold)), 20, 3)
    y1 = fused_partials_reduce(seed, *p1, **fold)
    torch.cuda.synchronize()
    y2 = fused_partials_reduce(seed, *p1, **fold)
    torch.cuda.synchronize()
    check("fused_mac_partials", f"scale_u65536 1x1 block_u {bu}",
          (B, U, K, N), p1, p2, kept["partials"])
    check("fused_partials_reduce", "scale_u65536 1x1", (B, G, K, N), y1, y2,
          kept["reduce"])
    for name, kms, pms, (bound, bound_by, issue), shape in (
            ("fused_mac_partials", ks, ps,
             partials_bound_ms(B, U, K, N, G, cycles["fused_mac_partials"]),
             [B, U, K, N]),
            ("fused_partials_reduce", rks, rps,
             reduce_bound_ms(B, G, K, N, cycles["fused_partials_reduce"]),
             [B, G, K, N])):
        timings[name, "scale_u65536 1x1"] = dict(
            ms=sum(kms) / 2, plain_ms=sum(pms) / len(pms), bound_ms=bound,
            bound_by=bound_by, shape=shape)
        log({"phase": "times", "kernel": name, "shape": "scale_u65536 1x1",
             "shape_BUKN" if name == "fused_mac_partials" else "shape_BGKN":
             shape, "block_u": bu, "kernel_ms": kms, "plain_ms": pms,
             "bound_ms": bound, "bound_by": bound_by, "issue_ms": issue,
             "card": card})
    del inp, args, p1, p2, y1, y2, kept

    # the whole cluster hop at the scale_u16384 shape on a 1x1 mesh:
    # u-sharded (partials + fold) against gathered (fused_mac)
    topo = u16384.make_topology()
    mesh = make_device_mesh("1x1", dev)
    g = torch.Generator(device=dev).manual_seed(51)
    deltas = 1e-2 * torch.randn(topo.C, topo.M, 7850, generator=g,
                                device=dev)
    key = prng.PRNGKey(51, dev)
    P = torch.tensor(1.0, device=dev)
    hop = {c: (lambda f=make_fused_cluster_hop(
        topo, u16384.whfl_config().ota, mesh, 3925, c): f(key, deltas, P))
        for c in ("u_sharded", "gathered")}
    u_ms, g_ms = in_turns(hop["u_sharded"], hop["gathered"], 5, 5)
    log({"phase": "times", "what": "cluster hop, u_sharded vs gathered",
         "shape_BUKN": [topo.C, topo.C * topo.M, topo.K, 3925],
         "u_sharded_hop_ms": u_ms, "gathered_hop_ms": g_ms, "card": card})
    del deltas, hop

    for label, shape, dtype, reps in (
            (f"{LM_ARCH} prefill B4 L4096", (4, 4096, 14, 2, 64), bf16,
             (20, 3)),
            (f"{LM_ARCH} prefill_32k B1 L32768", (1, 32768, 14, 2, 64), bf16,
             (10, 1)),
            # a rank's heads under "model" 2 in phase 11's training
            (f"{LM_ARCH} 'model' 2 shard B1 L4096", (1, 4096, 7, 1, 64),
             bf16, (20, 3)),
            (f"{LM_ARCH} 'model' 2 shard f32 B1 L4096",
             (1, 4096, 7, 1, 64), f32, (10, 3)),
            (f"{LM_ARCH} prefill f32 B4 L4096", (4, 4096, 14, 2, 64), f32,
             (10, 3)),
            (f"{F32_HD128_ARCH} prefill f32 B1 L4096",
             (1, 4096, 12, 2, 128), f32, (10, 3)),
            (f"{LM_ARCH} reduced prefill B4 L4096", (4, 4096, 4, 2, 32),
             bf16, (20, 3)),
            (f"{LM_ARCH} reduced prefill f32 B4 L4096", (4, 4096, 4, 2, 32),
             f32, (20, 3)),
            ("hd 16 B4 L4096", (4, 4096, 4, 2, 16), bf16, (20, 3)),
            ("hd 16 f32 B4 L4096", (4, 4096, 4, 2, 16), f32, (20, 3)),
            ("zamba2-7b prefill B4 L4096", (4, 4096, 32, 32, 112), bf16,
             (10, 2)),
            ("zamba2-7b prefill f32 B4 L4096", (4, 4096, 32, 32, 112), f32,
             (5, 2))):
        name, times = flash_times(label, shape, dtype, reps, dev, card,
                                  in_turns, time_ms, flash_pair, check_flash,
                                  queued=shape[-1] <= 32)
        timings[name, label] = times

    def record_err(name, err, rel):
        errors[name] = max(errors[name], err)
        rel_errors[name] = max(rel_errors[name], rel)

    # the query offset: a rank's rows under "q_seq" (phase 11)
    offset_kernels(dev, card, record_err, timings)

    # -- phase 8: the LM families ------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    log({"phase": "families", "run": "start",
         "device_allocated_bytes": torch.cuda.memory_allocated()})
    for arch, n_layers, pre, dec in FAMILY_RUNS:
        serve_family(arch, n_layers, pre, dec, dev, card, counted, expect)
        gc.collect()
        torch.cuda.empty_cache()
    # arctic-480b too: the MoE's dense residual branch
    for arch in [run[0] for run in FAMILY_RUNS] + ["arctic-480b"]:
        family_vs_cpu(arch, dev)

    # -- phase 9: federated LM training ------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    ranks_dir = tempfile.mkdtemp(prefix="smoke-ranks-")
    gloo_reference = os.path.join(ranks_dir, "structural.pt")
    train_phase(dev, card, expect, reference=gloo_reference)

    # -- phase 10: sliding-window attention ---------------------------------
    window_phase(dev, card, counted, expect, record_err, timings)

    # -- phase 11: W-HFL training with one process per mobile user --------
    gc.collect()
    torch.cuda.empty_cache()
    try:
        ranks_phase(card, expect, gloo_reference)
    finally:
        shutil.rmtree(ranks_dir, ignore_errors=True)

    # -- phase 12: the sharded sweep with one process per shard ------------
    gc.collect()
    torch.cuda.empty_cache()
    sweep_ranks_phase(card, expect, u256_one_process)
    del u256_one_process

    # -- phase 13: the records ---------------------------------------------
    records = [("fused_mac", "scale_u256", "src/repro/kernels/fused_mac.py:158",
                None),
               ("ota_combine", "fig2_iid cluster",
                "src/repro/kernels/ota_combine.py:121",
                "src/repro/kernels/ota_combine.py:31"),
               ("fused_mac_partials", "scale_u65536 1x1",
                "src/repro/kernels/fused_mac.py:312", None),
               # a jnp helper in the JAX package, a kernel here
               ("fused_partials_reduce", "scale_u65536 1x1",
                "src/repro/kernels/fused_mac.py:467", None),
               # the two flash kernels replace the one Pallas kernel: bf16
               # and float32 on the tensor cores, at every head dim
               ("flash_mha_wgmma", f"{LM_ARCH} prefill B4 L4096",
                "src/repro/kernels/flash_attn.py:39", None),
               ("flash_mha_tf32", f"{LM_ARCH} prefill f32 B4 L4096",
                "src/repro/kernels/flash_attn.py:39", None)]
    log({"phase": "done", "seconds": time.perf_counter() - t_start,
         "card": card})
    log({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/csrc/{KERNELS[name][0]}.cu",
        "replaces": replaces,
        **({"also_replaces": also} if also else {}),
        "launches": main_launches[name], "max_abs_err": errors[name],
        "max_rel_err": rel_errors[name],
        # the timed inputs' dtype: float32 (complex values as two planes)
        # for the W-HFL kernels, set by `flash_times` for flash
        "library_ms": None, "dtype": "float32", **timings[name, shape],
        # the kernel's times at its other timed shapes (flash: other head
        # dims and lengths), each with its own bound and library time
        "also_timed": [{"shape_label": label, **t}
                       for (n, label), t in timings.items()
                       if n == name and label != shape]}
        for name, shape, replaces, also in records]})
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


def training_only() -> int:
    """``python3 chip_smoke.py --training``: phases 1 and 2 for the flash
    kernels alone, then phase 9 (federated LM training), with launch
    counts as `main` keeps them; no kernel records."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a CUDA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load_all([src for src in SOURCES if src.startswith("flash")])

    train_phase(torch.device("cuda"), card.splitlines()[0], check_launches,
                trace=True)
    log({"phase": "done", "seconds": time.perf_counter() - T_START})
    return 0


def window_only() -> int:
    """``python3 chip_smoke.py --window``: phases 1 and 2 for the flash
    kernels alone, then phase 10 (sliding-window attention), with launch
    counts as `main` keeps them; no kernel records."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a CUDA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash = [src for src in SOURCES if src.startswith("flash")]
    build.load_all(flash)
    for name in flash:
        log({"phase": "build", "source": f"csrc/{name}.cu",
             "ptxas": [ln.strip() for ln in build.build_info(name)[1]
                       .splitlines() if "registers" in ln or "spill" in ln
                       or "entry function" in ln]})

    window_phase(torch.device("cuda"), card.splitlines()[0], counted,
                 check_launches, lambda *_: None, {})
    log({"phase": "done", "seconds": time.perf_counter() - T_START})
    return 0


def ranks_only() -> int:
    """``python3 chip_smoke.py --ranks``: phases 1 and 2 for the flash
    kernels alone, phase 7's query-offset checks (`offset_kernels`, the
    flash calls of phase 11's "q_seq" ranks), then phase 11 (training on
    ranks), with launch counts as `main` keeps them; no kernel
    records."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a CUDA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load_all([src for src in SOURCES if src.startswith("flash")])
    offset_kernels(torch.device("cuda"), card.splitlines()[0],
                   lambda *_: None, {})
    gc.collect()
    torch.cuda.empty_cache()
    ranks_phase(card.splitlines()[0], check_launches)
    log({"phase": "done", "seconds": time.perf_counter() - T_START})
    return 0


def sweep_ranks_only() -> int:
    """``python3 chip_smoke.py --sweep-ranks``: phases 1 and 2 for the
    W-HFL kernels alone, then phase 12 (the sharded sweep on ranks, with
    its own one-process references), with launch counts as `main` keeps
    them; no kernel records."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a CUDA "
              "card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    sweep_ranks_phase(card.splitlines()[0], check_launches)
    log({"phase": "done", "seconds": time.perf_counter() - T_START})
    return 0


if __name__ == "__main__":
    MODES = {"--training": training_only, "--window": window_only,
             "--ranks": ranks_only, "--sweep-ranks": sweep_ranks_only}
    sys.exit(MODES[sys.argv[1]]() if len(sys.argv) == 2
             and sys.argv[1] in MODES else main())
