"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name, capability and power limit;
2. build   — compile every kernel from ``hypha_tpu_torch/ops/csrc``, with
   each kernel's registers and spills from ``-Xptxas -v``;
3. kernels — the routes of the ragged kernel (decode: split-KV,
   GQA-packed, CUDA cores; simt: CUDA cores; mma: tensor cores) against
   its plain PyTorch version on the card (bf16 and int8 pools, MHA, GQA
   32/8 and 28/4, Sq 1 on all three routes, Sq 16 and 64 on simt and mma,
   poisoned garbage and unallocated blocks, an idle lane that must be
   exactly zero, windows with a k_start floor, a prefix cache's chunks at
   q_offset 320 and 351 over 20 blocks two lanes' tables share
   (``shared_prefix_case``), each route's output bit-identical on a second
   launch), then the routes timed on the same
   inputs at the Llama-2-7B serving shape beside the plain version, one
   PyTorch library call computing the same function, and the card's
   bound: decode L2-cold (CUDA graphs rotating over enough independent
   pools that a cycle reads >= 200 MB), and warm on one pool; prefill
   chunks of 16 and 64 as before;
4. serve   — full-width Llama-2-7B (seeded random weights, bf16) behind
   ``PoolServer`` -> paged, ragged ``DecodePool``: concurrent greedy
   requests through asyncio; prefill chunks must have launched the mma
   route and decode steps the decode route, each once per layer per
   forward, and the plain attention path never;
5. serve_int8 — the same pool with int8 KV blocks, at ``CLI_LAYERS`` (run
   after ``reference``, on the 8-layer model);
5b. serve_prefix — ``prefix_requests`` (4 families of 4 prompts sharing a
   320-token prefix, one an aligned repeat that copies a shared block)
   through the same pool at ``CLI_LAYERS`` (run after ``reference``, on
   the 8-layer model of the network's phases, whose references it gives)
   with the prefix cache on and off, bf16 and int8:
   the answers equal, hits and copy-on-writes above 0, fewer prefill
   forwards with the cache, the kernel only (``serve_prefix_phase``);
5c. serve_spec — speculative decoding and the fixed-slot pool on the same
   8-layer model (``serve_spec_phase``): echo and settled traffic, bf16
   spec off, ``spec_ngram``, ``spec_layers`` and a fixed-slot pool, f32
   spec off, ``spec_ngram`` and fixed-slot; gates (a)-(f): f32 tokens
   equal across the three, every request's count, drafts accepted and
   fewer forwards an emitted token where every lane proposes, verifies on
   ``ragged_mma_kernel`` and the self-draft on ``ragged_decode_kernel``,
   no plain attention;
6. profile — one decode step and one prefill chunk at the serving shape
   under the profiler: host and device time, the ragged kernels
   (``RAGGED_NAMES``) by name, the decode kernel (and its merge, when the
   shape splits) and the prefill chunk's mma kernel once per layer per
   forward;
7. reference — the 7B decode forward (through the kernel) against the
   training forward (plain attention), and a tiny f32 Llama whose pool
   tokens must equal one-shot ``generate``;
8. serve_node — ``serve``'s requests over the network: a gateway, a worker
   and a scheduler, each ``python -m hypha_tpu_torch <role> run`` from a
   TOML its ``init`` wrote (``run_serve_node``); the scheduler's serve job
   (``SERVE_JOB``, the pool of ``serve``) auctions the worker, which loads
   the 7B widths at ``CLI_LAYERS`` (8) and serves them through the ragged
   kernel; this process is the client (``generate_remote``). Gates
   (``serve_node_problems``): the answers equal ``serve``'s at that depth
   (``serve_cli_reference``) token for token and the repeats equal, the
   worker's launch line shows mma and decode launches in multiples of 8
   layers and no plain call, no fallback, no kernel built anew, and each
   process exits 0 within 30 s of SIGTERM, leaving no work dir; it
   reports bring-up, dispatch to the first answer, each request's latency
   and the wall time beside ``serve``'s, and the worker's peak memory;
8b. serve_router — ``serve_prefix``'s requests through the scheduler's
   router (``ROUTER_JOB``: two workers, prefix cache, prefix affinity,
   queue limit 4): a gateway, workers ``w0`` and ``w1`` and a scheduler,
   each a process (``ServeNet``, ``run_serve_router``); all 16 at once,
   the first 4 again, then ``w1`` SIGKILLed and the last 4 again. Gates
   (``serve_router_problems``): every answer ``serve_prefix``'s, both
   workers served through the kernel only with no kernel built anew,
   prefix-cache hits, the router's counts logged, ``w1``'s slot failed (by
   φ ejection or its lease, whichever first) and ``w0`` answered after
   the kill, exits 0 and no leftovers; it reports bring-up, dispatch to
   the first answer, latencies, wall, retry-after answers, the card's
   memory during bring-up, each worker's peaks and the kill-to-failure
   time. It runs the live metrics plane (``router_slo_rules``): gates
   (``router_metrics_problems``) ``silent_s <= 3`` breached for ``w1``
   alone after its kill, the p99 rule held, each worker's latency count in
   the journal equal to the requests it answered, ``telemetry.top --once``
   listing both workers live and every reporter from the journal;
8c. serve_fleet — the fleet prefix cache and KV migration (``FLEET_JOB``: two
   workers, prefix cache, fleet cache, migration, digest 32, prefill
   chunks of 32, 40 blocks a pool), gateway, ``w0``, ``w1`` and scheduler
   each a process (``run_serve_fleet``): straight to backend 0, a
   blocker, then 4 hogs whose growth dries the pool, a long request and a
   short one (``MIGRATE_REQUESTS``): the short one is preempted and ships
   to the other backend (the router's hint), the long one's chain passes
   the 32 MiB frame and it is requeued; through the router, a family of
   prompts sharing a 32-token prefix, the holder busy, so one lands on the
   other backend and pulls the chain over ``/hypha-blocks``; then
   ``serve_prefix``'s 16, one of them stamped to pull a 20-block chain
   past the frame (``fleet_traffic``). The in-process pools answer the
   same requests first, the dry-pool ones with the migration path in
   process (``fleet_reference``).
   Gates (``serve_fleet_problems``): every answer the in-process pool's
   (``serve_prefix``'s for its 16), a pull landed (hits on the puller,
   blocks shipped by the holder at 8,388,608 bytes each) with fewer
   prefill forwards than the cold request, each on the mma route, a
   migration acked, both workers through the kernel only, clean exits;
   it reports each pull's and migration's seconds and MB/s, the
   ``LinkTable`` estimate, transfer against recompute choices, requeues,
   the frame-cap failures with their seconds, the router's directory
   entries, the card's memory, bring-up and the phase's seconds;
9. flash_kernels — the flash-attention forward, dQ and dK/dV kernels
   against their plain versions (bf16; MHA 32/32 and GQA 32/8; causal and
   not; S 2048, a ragged 1000, Sq != Sk; head_dim 128 and 64; sliding
   windows, Mistral-7B's 4096 at S 4608 among them), the forward, dQ and
   dK/dV bit-identical on a second launch, then each kernel's time at the
   training shape beside its plain version, SDPA and the card's bound;
10. train — the serving model freed, ``run_training`` at Llama-2-7B widths
   cut to 1 layer (``TRAIN_LAYERS``; S 2048, batch 2, remat) behind an
   in-process scheduler
   and parameter server (the port's ``RoundAccum`` and ``outer_step`` on
   the card, ``ps_round``):
   2 rounds of 4 inner steps through the three flash kernels, checking
   launch counts, zero plain-attention calls, finite and falling losses
   and exact merges; step time, tokens/s, peak memory and the kernels'
   device time per step from the profiler, where one step must show each
   bf16 tensor-core flash kernel with its launches (2 / 1 / 1);
11. train_node — the ``train`` phase's job cut to 1 layer
   (``NODE_LAYERS``: its gates are the network's and the scheduler's), run
   by
   the port alone (``run_node_job``) on ``TcpTransport`` at 127.0.0.1: a
   ``Gateway``, a ``DataNode`` serving the slices, a ``WorkerNode`` ``w0``
   whose process executor runs the trainer CLI on the card, a
   ``WorkerNode`` ``psw`` whose ``ParameterServerExecutor`` folds and
   steps on the card, and the port's scheduler, ``Orchestrator.run`` on a
   ``DiLoCoJob`` with the JAX CLI's defaults (the allocator's 2 s auction,
   the batch scheduler's countdown, the slice scheduler) but for the
   no-progress watchdog, held at the reference's whole-run 600 s
   (``NODE_STATUS_TIMEOUT_S`` says why); gates on both jobs running then
   completed, ``JobResult.rounds``, 8 samples (4 batches of 2) a round,
   the dispatched batch 2, the jobs' placement, the server's ``UPDATED``,
   falling round losses, 32 / 16 / 16 flash launches and no plain call
   (the trainer's log), each received Δθ's flat f32 names and shapes, no
   failed renewal and no file left behind; from stamps inside the
   scheduler: step ms, tokens/s, the round boundary, the largest gap
   between progress messages beside the adaptive watchdog's deadline,
   the batch scheduler's ms per message; each Δθ push and broadcast with
   its bytes, the fold and ``outer_step`` seconds, auction to dispatch,
   dispatch to first heartbeat and the trainer's peak memory;
11b. train_data — the input pipeline (``train_data_phase``) on
   ``NODE_MODEL`` (7B widths at 1 layer, [2, 2048], remat) in slices of
   ``DATA_SAMPLES`` (4: 2 batches), int8 deltas: (a) one job through
   ``run_training`` twice over one set of slices behind a local session
   (``DataSession``), the pipeline off and then on with ``prefetch_slices``
   2, ``DATA_A_ROUNDS`` of ``DATA_A_STEPS``: the loss sequences equal float
   for float and the flash launches equal; (b) the port's nodes
   (``run_data_job``) with two trainer processes, ``input_pipeline`` and
   ``prefetch_slices`` 2, the workers' slice caches on, ``DATA_B_ROUNDS``
   of ``DATA_B_STEPS``, the data node killed as the first network pull
   after round 1's first delta starts and restarted ``DATA_RESTART_S``
   later under its peer id and port (``data_chaos``). Gates
   (``data_problems``): ``node_problems``, ``attempt`` 0, a trainer's
   ``prefetch_errors`` >= 1, no held window over 2, every epoch that
   wrapped served every slice first, at most 4 slice files in a job
   directory at once (``slice_files_watch``), each cache within its bound,
   each trainer's flash launches its batches', clean exits. It reports each
   trainer's ``data metrics`` line (input-wait seconds and fraction,
   boundary waits and their mean, the queue's peak, slices fetched,
   prefetch errors), the nodes' pulled bytes and cache hits and misses,
   step ms, kill to restart, and part (a)'s snapshots: the sync run's is the
   stall the pipeline hides;
12. train_stream — ``train_node``'s job and fabric (1 layer)
   with the compressed streaming outer sync: ``delta_codec`` int8,
   ``sync_mode`` stream, 4 fragments, 4 rounds of 8 batches of 2 (every
   fragment syncs once), the trainer quantizing each due fragment's Δθ on
   the card in its flight thread while the inner steps go on, the server
   folding the int8 frames and re-encoding its update on the card; gates
   (``stream_problems``) on both jobs completed, ``UPDATED`` every round,
   finite falling round losses, the due fragments exactly the tree's
   ``partition_names`` each once, every push an HQD1 int8 frame whose tag
   matches its header, the flash launches of every batch trained (flights
   included) and no plain call, no failed renewal, no file left behind,
   and the card's ``quantize`` byte-equal to the CPU's on round 0's f32
   update fragment (payload and scales); it reports per round the bytes
   pushed and broadcast with their seconds, the fold, ``outer_step`` and
   encode seconds, the flight and how long ``finish`` waited, step ms with
   and without a flight out, the largest progress gap beside the adaptive
   deadline, the trainer's and the server's peaks, and tokens/s;
12b. train_secure — ``train_stream``'s job for 2 rounds on a secured
   network of CLI processes (``run_secure_job``): the port's certutil (as
   processes) writes a root, an org and a certificate per node, and a CRL
   revoking worker ``wx``'s; gateway, data node, ``psw``, ``w0``, ``wx``
   and the scheduler each run ``python -m hypha_tpu_torch <role> run``
   with a ``[tls]`` section (certificate, trust root, the org's CRL) and
   ``network.mux`` on, ``w0``'s trainer spawned through ``executor.cmd`` /
   ``executor.args``; a plain-TCP node dials the gateway. Gates
   (``secure_problems`` and the flash launches of every batch trained, no
   plain call): the scheduler's rounds, ``UPDATED`` each round, both jobs
   completed, falling losses, each node's logged peer id equal to
   ``certutil node``'s, ``wx`` never up nor dispatched and refused by the
   gateway for revocation, the plain dial refused, a tagged push and
   broadcast a round, every gossip frame verified, clean exits, no file
   left. It reports each push's and broadcast's bytes, seconds and MB/s
   under TLS beside ``train_stream``'s plain-TCP ones, step ms with and
   without a flight out, auction to dispatch, each node's connections,
   refused handshakes, mux streams and gossip counts with the median
   pure-Python verify ms, the largest progress gap against the watchdog,
   the trainer's peak, ``ssl.OPENSSL_VERSION`` and the phase's seconds;
12c. train_ft — run by a child process (``python3 chip_smoke.py --phase
   train_ft``, ``ChildPhase``) beside ``serve_node``, ``serve_router``,
   ``serve_fleet``, ``train`` and ``train_node``, its line printed when
   it is joined, after ``train_node`` (with when it started and ended and
   the join's wait): fault-tolerant blocking DiLoCo (``run_ft_job``): 7B widths
   cut to 1 layer (``FT_LAYERS`` says why), int8 deltas, 6 rounds of 4
   steps, two trainer processes on the card under the port's scheduler
   with ``FTConfig`` (quorum 0.5, one parameter-server restart),
   ``checkpoint_dir`` (trainer checkpoints every 4 rounds, the durable
   server every 2), ``scheduler_recovery`` and a ``ChaosController``
   (``FT_CHAOS``): ``w1`` killed after
   its round-0 delta, round 1 closed on ``w0`` alone, a spare ``w2``
   auctioned and caught up through the server's Σ; the parameter server
   killed at round 3's first journaled delta and restarted under its peer
   id on a new port, replaying round 2 from its journal; the scheduler
   killed at round 4's first journaled delta (``run_ft_job`` says when it
   restarts) and restarted under its peer id, adopting ``w0``, ``w2`` and
   the server from its journal (``scheduler_problems``: one recovery at
   generation 2, three AdoptAcks inside the deadline, no auction or
   dispatch after the kill, round 4 broadcast during the outage with two
   folds and no dedup hit, the frontier fast-forwarded to round 5, every
   answer to a trainer after the restart stamped with generation 2 and
   its round, the parked sends answered by generation 2, no stale drop,
   the θ track over all six rounds, the journal gone after DONE). Gates
   (``ft_problems``): every round ``UPDATED`` once and ``attempt`` 0,
   round 1 collected ``w0``'s delta alone with ``w1``'s absence logged,
   ``w2``'s θ after the catch-up equal to θ₀ + Σ of the broadcast updates
   bit for bit (its logged checksum against ``ThetaTrack``'s), the server
   at generation 2 with round 2's replayed wire byte-equal to the stored
   one, each worker's round-3 delta journaled once and one re-send a dedup
   hit, the trainers' checkpoint versions the schedule implies, the flash
   launches of every batch and no plain call, no leftover file outside the
   checkpoint root, clean stops, and enough free disk for the checkpoints
   (``ft_bytes_needed``). It reports each round's boundary, the round-1
   close wait, kill to departure, departure to ``w2``'s first heartbeat,
   the catch-up's bytes and seconds, kill to generation 2's first
   broadcast, the replay, each checkpoint's seconds and bytes, the
   journal's records and bytes, each trainer's and the card's peak
   memory, the free disk before and after, and the scheduler's kill to
   restart, restart to the last AdoptAck, each round's wall, the outage's
   added wall against one round plus ``FT_RESTART_BUDGET_S``, its
   journal's records and bytes and the parked attempts;
12d. train_shard — the sharded parameter service and the tree reduce
   (``train_shard_phase``): ``run_node_job`` with two parameter-server
   hosts ``psw0`` and ``psw1`` (the distinct-peer auction puts one shard
   on each). Job S: 1 layer (``SHARD_S_MODEL``), three trainer processes,
   ``SHARD_S_OPTIONS`` (stream, 4 fragments, int8, 2 shards, one reduce
   group of 3 with ``w0`` its reducer), ``SHARD_S_ROUNDS`` x
   ``STREAM_STEPS``; Job B: 1 layer, two trainers, blocking over 2
   shards, 2 rounds of 2. Each job first checks the card's free memory
   against ``shard_bytes_needed`` and fails with the numbers. Gates
   (``shard_stream_problems``, ``shard_blocking_problems``): each stream
   round's update from the shard owning its fragment, which took ``w0``'s
   delta directly, nothing directly from ``w1`` or ``w2``, and ``w0``'s
   cumulative partials, the last covering ``[w1, w2]``, the other shard
   nothing that round; every broadcast stamped with its shard; each
   trainer merging each round once; every partial the reducer encoded
   bit-equal to the harness's own ``RoundAccum`` fold on the CPU of the
   same files in the same order (``reducer_probes``); the card's
   ``quantize`` byte-equal to the CPU's; in Job B each trainer pushing one
   part to each shard a round, the parts ``shard_names``' disjoint cover,
   each round advanced only after both shards' ``UPDATED``, both parts
   landed and merged every round; the usual flash launches of every
   batch, no plain call, clean exits, no leftover file. It reports per
   shard and round the pushes, bytes, fold, ``outer_step`` and encode
   seconds; the reducer's flushes (fold, encode and forward seconds,
   bytes, covers) and re-flushes a round; step ms with three trainers,
   the round boundary, flights, each trainer's peak, the servers' and
   reducer's peak and the card's, and the phase's seconds;
12e. train_shard_ft — fault tolerance of Job S (``run_shard_ft_job``):
   ``SHARD_S_OPTIONS`` with ``FTConfig`` (quorum 0.5, deadline 70 s, one
   shard restart), durable shards under ``<checkpoint_dir>/ps<k>``
   checkpointed every 2 of their own commits, trainer checkpoints at the
   last of 4 rounds of ``STREAM_STEPS``, the reducer's flush timer at 2 s
   (``SHARD_FT_FLUSH_S``); ``SHARD_FT_CHAOS``: group member
   ``w2`` killed once shard 1 journaled the round-1 partial covering it,
   a spare ``w3`` caught up through one catch-up per shard; shard 1's
   host killed after the rejoin, idle between its committed round 1 and
   its round 3, and restarted under its peer id once shard 0 closed round
   2. Gates (``shard_ft_problems``): ``attempt`` 0 and every round
   ``UPDATED`` once from its due shard, every job completed, ``w3`` for
   ``w2``, a round of shard 0 closed during shard 1's outage, shard 1 at
   generation 2 with each replayed round's wire byte-equal to the stored
   one and a replayed round holding a prefold partial with its covers,
   re-sends only of shard 1's rounds and none at shard 0, ``w3``'s θ
   after its catch-ups equal to θ₀ + Σ of the broadcast updates unioned
   over both shards bit for bit, each trainer's checkpoint versions, the
   flash launches of every batch, clean stops, no leftover file, and
   enough free disk (``shard_ft_bytes_needed``). It reports kill to
   departure, departure to ``w3``'s heartbeat, each shard's catch-up
   bytes and seconds, shard kill to generation 2's broadcast, the replay,
   each shard's checkpoints and journal, the other shard's rounds during
   the outage, step ms, peaks and the phase's seconds;
12f. train_het — WAN-adaptive rounds under the degrade chaos kinds
   (``run_het_job``): ``het_job`` (7B widths at 1 layer, blocking, int8,
   four trainer processes, ``adaptive_steps`` and ``adaptive_codec`` at
   ``HET_HI_MBPS`` / ``HET_LO_MBPS``, quorum 0.5, ``HET_DEADLINE_S``,
   ``HET_ROUNDS`` (3) of a base of ``HET_STEPS``) under ``HET_CHAOS``:
   ``w1``'s link capped both ways, ``w2``'s batches slowed, ``w3``'s
   pushes jittered.
   Gates (``het_problems``): (a) ``w1``'s round-0 int8 delta lands inside
   the first-round grace and no delta is dropped or abandoned; (b) from
   round 0's broadcast ``w1``'s link is int4 both ways (its frame headers,
   one logged switch) and every other link int8; (c) ``w2`` runs fewer
   than the base steps from round 2; (d) each round's published
   assignment equals the batches each trainer ran and the sample weight
   the server folded; (e) each per-peer wire decodes to update + residual
   before - residual after on the card, no residual shared; (f) the flash
   launches of every batch; (g) every round closed, clean exits, no file
   left. It reports per round the assignments, arrival lags, link
   estimates, codecs, wire bytes, encode seconds and wall seconds, step
   ms per trainer, the server process's and the card's peaks. It runs the
   live metrics plane (``het_slo_rules``): gates (``het_metrics_problems``)
   reports from the server and every trainer's node, each round's
   assignment in the server's ``hypha.het.assigned_steps`` gauges, the
   journal's quality points equal to the trainers' METRICS,
   ``round_wall_s <= 10`` breached once and the quorum-drop rule never;
12g. train_swap — the broadcast tree and live weight swap (``run_swap_job``):
   ``swap_job`` (7B widths at 1 layer, blocking, int8, 3 rounds of 4
   steps, one reduce group of ``w0``-``w2`` with ``w0`` its reducer and
   relay, ``broadcast_tree``, ``serve_peers`` ``[sv0]``, quorum 0.5,
   deadline 70 s); ``sv0`` serves the same seeded θ₀ in bf16 (paged,
   ragged, prefix cache) and follows the job from θ₀ (``follow_for``,
   ``keep_previous``) while two closed-loop clients ask it for 32 tokens
   after prompts of 17-200 tokens, and a probe goes out after each round
   it applies; ``w0`` is killed once its relay handed round 1 on. Gates
   (``swap_problems``): every relayed wire byte-equal (sha-256) to the
   server's with its header; one push a round, to the relay, while it
   lives, then the leaves directly; every round ``UPDATED``, the
   survivors' deltas straight to the shard, every live leaf every round,
   no round held; each flip's served leaves (the digest sv0 logs) equal to
   θ₀ + Σu folded on the card as the pool folds (``swap_check``); each
   probe's tokens a fresh pool's on those weights; no request failed or
   short, stamps among the applied rounds and never falling, no admission
   mapping an older generation's chain, the allocator's generation one a
   swap; the trainers' flash launches and ``sv0``'s ragged launches
   exact. It reports relay hop seconds, stage-to-flip ms, decode-chunk
   gaps at each flip, ``sv0``'s tokens/s before and after the first swap,
   kill to departure, the card's peak and the phase's seconds;
12h. train_lora — LoRA DiLoCo from an HF-format checkpoint
   (``run_lora_job``): the smoke writes the seeded base of 7B widths at
   ``LORA_LAYERS`` (2) as one bf16 SafeTensors file in HF names, and a
   ``DiLoCoJob`` with ``lora`` (``LORA``: rank 16, α 32, q/k/v/o) names it
   as its ``source``: the port's gateway, data node, server host and two
   ``WorkerNode``s whose trainers run in process (``lora_probes`` sees
   inside them), ``LORA_ROUNDS`` of ``LORA_STEPS`` at [2, 2048], remat.
   Gates: (a) every Δθ and update exactly the adapters (16 at 2 layers)
   under the JAX package's flat names, f32, 4,194,304 bytes plus a header
   at 2 layers (``lora_wire_spec``); (b) each
   trainer's base bit-equal to the checkpoint after conversion at the end;
   (c) every merge θ_t + u bit for bit over the adapters; (d) the flash
   launches of every batch (each trainer's attention calls counted) and
   the parameters on ``cuda``; (e) finite round losses (printed, no fall
   gated); (f) ``fold_lora`` of ``w0``'s adapters, written as an HF
   checkpoint directory and streamed by ``load_model`` into a
   ``lora_rank=0`` bf16 model: its logits on a [2, 256] probe within
   ``LORA_FOLD_TOL`` of the adapters', and greedy tokens through the pool
   on the ragged kernel. It reports the checkpoint's write, fetch and load
   seconds, push and broadcast bytes and seconds a round, step ms and
   tokens/s per trainer, the process's and the card's peaks;
12i. lora_7b — the whole Llama-2-7B (32 layers, f32 base, seeded) trained
   with ``LORA`` through ``run_training`` behind ``LoraSession``: one round
   of ``LORA_7B_STEPS``; gates: base checksum unchanged, every adapter
   changed, finite losses, 2 x 32 / 32 / 32 flash launches a step, the
   peak under the card's memory; then ``chunked_causal_ce`` against
   ``compute_loss`` CE on the 7B head ([2, 2047] hidden states; value and
   hidden gradient within ``CHUNKED_CE_TOL``, each one's peak), and four
   AdamW steps with a bf16 ``mu`` against f32 on the adapters (moment bytes,
   parameter gap). The seeded init draws through ``seed_init_draw`` (one
   launch a drawn leaf), held bit-equal to the CPU's draws at both ends of
   each distinct leaf and timed beside the ``torch.Generator`` init it
   replaced. It reports step ms, tokens/s and the peak;
13. train_reference — a tiny Llama (head_dim 64), and the same with a
   sliding window below its sequence (Mistral's local attention), each
   trained 4 steps through the kernels and through the plain flash version
   from the same weights, with no call of the dense attention;
14. serve_moe — Mixtral-8x7B widths at ``MOE_LAYERS`` (16 of 32; run
   after ``serve_fleet``), seeded, bf16, ``serve``'s requests through
   ``serve_phase``'s pool. A bf16 router flips its picks at near-ties
   between the kernel path and the plain path, and a flip moves the whole
   residual, so each comparison routes the plain forward as the kernel
   path routed (``router_tape``, ``pool_routing``): (a) every greedy token
   of a recorded pool run the plain path's (the same model without a
   cache, the plain attention, drop-free MoE), teacher-forced on the
   pool's own tokens, a split only where the plain forward's logit of the
   pool's token lies within ``MOE_LOGIT_TOL`` of its top logit (the
   splits at a ``BF16_NEAR_TIE`` counted); (b) a [8, 64] prefill chunk
   through the paged cache within ``MOE_LOGIT_TOL`` of the largest logit
   of the plain forward (the unpinned flips and error reported); (c)
   ragged launches by route exactly forwards x 16 (decode on the decode
   steps, mma on the chunks), no simt, no plain attention; (d) a clean
   exit. It reports load and init seconds, the peaks, decode and wall
   tok/s, and ``profile_phase``'s decode step and prefill chunk beside
   the decode step's bound (every weight read once);
15. train_moe — Mixtral-8x7B widths at 1 layer (1.71 B parameters),
   remat, capacity routing (C = 640), one blocking int8 DiLoCo job on the
   port's nodes with the trainer in process (``run_moe_job``), 2 rounds
   of 4 at [2, 2048]: (a) losses fall (``node_problems``, which also holds
   the job's states, rounds, samples and dispatch); (b) the aux loss
   finite and within [0, ``router_aux_coef`` x E] every step; (c) flash
   launches 2 x 1 x batches (fwd, remat) and 1 x batches (dQ, dK/dV), no
   plain attention; (d) the int8 Δθ frames carry the experts and the
   router in the JAX package's flat names and shapes; (e) the trainer's θ₀
   the seed's (``ThetaTrack``) and every merge θ_t + u bit for bit; (f) no
   file left. It reports step ms, tokens/s, the peaks, drop_frac and aux
   per step, the round boundary and its parts, and one profiled step.

Then the kernels line, the ``nvidia-smi`` name and power limit line, and
the result line. Any failure exits non-zero before the result line; with
no CUDA device it exits 2 at once.
"""

from __future__ import annotations

import asyncio
import atexit
import collections
import gc
import hashlib
import json
import math
import os
import queue
import re
import shutil
import signal
import socket
import ssl
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager, nullcontext
from datetime import datetime
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; f32 outside tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # unit-variance inputs; bf16 output rounding
KERNEL_SOURCE = "hypha_tpu_torch/ops/csrc/ragged_paged_attention.cu"
REPLACES = "hypha_tpu/ops/paged_attention.py:213"
FLASH_SOURCE = "hypha_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_attention_forward": "hypha_tpu/ops/flash_attention.py:115",
    "flash_attention_dq": "hypha_tpu/ops/flash_attention.py:177",
    "flash_attention_dkv": "hypha_tpu/ops/flash_attention.py:222",
}
# bf16 outputs round to 8 mantissa bits, and the kernels round P and dS to
# bf16 at other points of the online softmax than the plain versions: o
# within 2e-2 (unit-variance inputs), L (f32) within 1e-3, gradients within
# 2e-2 of the case's largest |gradient|.
FLASH_TOL = {"o": 2e-2, "lse": 1e-3, "grad_rel": 2e-2}
# The bf16 flash kernels (tensor cores) as the profiler names them; its rows
# are matched by substring, so a kernel renamed in the source would read 0
# ms here (tests/test_torch_flash_kernels_contract.py holds the two together).
FLASH_NAMES = ("flash_fwd_mma_kernel", "flash_dq_mma_kernel", "flash_dkv_mma_kernel")
# The ragged kernels, matched the same way (tests/test_torch_ragged_kernels_contract.py).
RAGGED_NAMES = ("ragged_kernel", "ragged_mma_kernel", "ragged_decode_kernel",
                "ragged_decode_merge_kernel")
COLD_BYTES = 200e6  # bytes one L2-cold rotation reads: four times the H100's 50 MB L2
ROUTES = ("decode", "mma", "simt")  # the ragged kernel's routes, as the wrapper counts them
SPLIT_SWEEP = (1, 2, 3, 4, 6, 8)  # decode key splits timed beside _decode_splits' choice
# 8 layers until train_het joined the smoke: the in-process round boundary
# (7.5 GB of f32 Δθ through host files each way) was ~90 s of its ~105.
# 1 layer since train_data joined the smoke (2 since train_het, 8 before).
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_ROUNDS, TRAIN_STEPS = 1, 2048, 2, 2, 4
# Launches of each in one inner step: the forward twice per layer (remat).
STEP_LAUNCHES = dict(zip(FLASH_NAMES, (2 * TRAIN_LAYERS, TRAIN_LAYERS, TRAIN_LAYERS)))
TRAIN_PERIOD = 1024  # the data counts modulo this; the model's vocabulary stays 32000
# A LoRA fold served in bf16 (train_lora's gate (f)): max |Δ logits| over
# max |logits| between the folded model and the adapters'. The JAX
# package's own fold of a tiny bf16 model reaches 0.019
# (tests/test_torch_lora.py::test_split_merge_fold_match_jax).
LORA_FOLD_TOL = 0.05
# chunked_causal_ce against compute_loss CE (lora_7b's probe): the loss
# relative to itself, the hidden gradient relative to its largest entry
# (tests/test_torch_train.py::test_chunked_causal_ce_matches_jax holds the
# JAX package's to it too).
CHUNKED_CE_TOL = 1e-5


_T0 = time.perf_counter()


# The fault phases' roots (their trainers' and shards' checkpoints, ~20 GB
# a phase) are removed by a thread while the next phases run: on a slow disk
# the removal took a minute of the smoke's wall. A phase that needs the disk
# waits for them (``await_removals``), and main waits before its last lines.
_REMOVALS: list = []


def remove_later(path: Path) -> None:
    """Remove ``path`` in a thread of its own; its seconds land in
    ``_REMOVALS``."""
    rec: dict = {"path": str(path)}

    def work() -> None:
        t0 = time.perf_counter()
        shutil.rmtree(path, ignore_errors=True)
        rec["s"] = time.perf_counter() - t0

    rec["thread"] = threading.Thread(target=work, name=f"remove {path.name}", daemon=True)
    _REMOVALS.append(rec)
    rec["thread"].start()


def await_removals() -> list:
    """Wait for every removal started; each one's path and seconds."""
    for rec in _REMOVALS:
        rec["thread"].join()
    return [{"path": r["path"], "s": r.get("s")} for r in _REMOVALS]


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also says when it ended (``at_s``,
    seconds since the script started), so the phases' shares of the time
    limit can be read from the log."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas(log: str) -> list:
    """Each kernel's registers, spills and shared memory from ``-Xptxas -v``."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:  # the mangled name, cut to the kernel and its template arguments
            k = re.search(r"\d+([a-z_]+_kernel)I(\w+?)EEEv", m.group(1))
            name = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)
            out.append({"kernel": name})
        elif name and ("spill" in ln or "registers" in ln):
            out[-1]["spill" if "spill" in ln else "usage"] = ln.split(":", 1)[-1].strip()
    return out


def time_ms(fn, *, reps: int = 5, iters: int = 20, warmup: int = 3) -> float:
    """Median per-call device time of ``fn`` over ``reps`` event-timed runs
    of ``iters`` calls each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


# ------------------------------------------------------------- kernel phase


def paged_case(gen, *, B, sq, hq, hkv, D, bs, max_blocks, blocks, occupancy, quant,
               dtype=torch.bfloat16, idle=(), poison=1e4):
    """A pool-valid paged state on the card: lane b holds ``occupancy[b]``
    disjoint blocks (prefix-packed), its queries end at its last occupied
    position; every block no lane holds (the garbage block included) is
    poisoned; ``idle`` lanes hold only sentinels."""
    from hypha_tpu_torch.ops.kvcache import _quantize_rows
    from hypha_tpu_torch.ops.paged_attention import PagedKV

    dev = torch.device("cuda")
    rows = (blocks + 1) * bs
    k = torch.randn((rows, hkv, D), generator=gen, device=dev)
    v = torch.randn((rows, hkv, D), generator=gen, device=dev)
    perm = torch.randperm(blocks, generator=gen, device=dev).tolist()
    table = torch.full((B, max_blocks), blocks, dtype=torch.int32)
    qoff = torch.zeros((B,), dtype=torch.int32)
    held = torch.zeros((blocks + 1,), dtype=torch.bool)
    for b in range(B):
        if b in idle:
            qoff[b] = max_blocks * bs
            continue
        ids = [perm.pop() for _ in range(occupancy[b])]
        table[b, : len(ids)] = torch.tensor(ids, dtype=torch.int32)
        held[ids] = True
        qoff[b] = max(occupancy[b] * bs - sq, 0)
    unreachable = (~held).repeat_interleave(bs).to(dev)
    k[unreachable] = poison
    v[unreachable] = poison
    if quant:
        (k, ks), (v, vs) = _quantize_rows(k), _quantize_rows(v)
    else:
        k, v, ks, vs = k.to(dtype), v.to(dtype), None, None
    q = torch.randn((B, sq, hq, D), generator=gen, device=dev).to(dtype)
    kv = PagedKV(k, v, ks, vs, table.to(dev))
    return q, kv, qoff.to(dev), unreachable


SHARED_BLOCKS = 20  # the prefix-cache case: 320 positions of blocks two lanes map
SHARED_QOFF = (320, 351, None, 200)  # lane 2 idle


def shared_prefix_case(gen, *, quant, hq=32, hkv=32, D=128, bs=16, max_blocks=64, blocks=512,
                       sq=64, poison=1e4):
    """A prefix-cache state on the card: lanes 0 and 1 map the same
    ``SHARED_BLOCKS`` physical blocks first (a cached prefix), then blocks
    of their own; lane 0's chunk starts at position 320, past the hit, and
    lane 1's at 351, inside its last shared block (a capped hit); lane 2
    is idle and lane 3 holds blocks of its own. Every block no lane holds
    is poisoned."""
    from hypha_tpu_torch.ops.kvcache import _quantize_rows
    from hypha_tpu_torch.ops.paged_attention import PagedKV

    dev = torch.device("cuda")
    rows = (blocks + 1) * bs
    k = torch.randn((rows, hkv, D), generator=gen, device=dev)
    v = torch.randn((rows, hkv, D), generator=gen, device=dev)
    perm = torch.randperm(blocks, generator=gen, device=dev).tolist()
    shared = [perm.pop() for _ in range(SHARED_BLOCKS)]
    table = torch.full((4, max_blocks), blocks, dtype=torch.int32)
    held = torch.zeros((blocks + 1,), dtype=torch.bool)
    qoff = torch.full((4,), max_blocks * bs, dtype=torch.int32)
    for lane, off in enumerate(SHARED_QOFF):
        if off is None:
            continue
        n = -(-(off + sq) // bs)
        head = shared if lane < 2 else []
        ids = head + [perm.pop() for _ in range(n - len(head))]
        table[lane, :n] = torch.tensor(ids, dtype=torch.int32)
        held[ids] = True
        qoff[lane] = off
    unreachable = (~held).repeat_interleave(bs).to(dev)
    k[unreachable] = poison
    v[unreachable] = poison
    if quant:
        (k, ks), (v, vs) = _quantize_rows(k), _quantize_rows(v)
    else:
        k, v, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    q = torch.randn((4, sq, hq, D), generator=gen, device=dev).to(torch.bfloat16)
    return q, PagedKV(k, v, ks, vs, table.to(dev)), qoff.to(dev), unreachable


def graph_turns(contenders: dict, n: int, *, cycles: int, reps: int = 6) -> dict:
    """Median device ms per call of each contender. ``contenders[name](i)``
    launches one call on pool i; each contender's ``cycles`` passes over
    pools 0..n-1 are captured once into a CUDA graph (so the host's
    launch time stays out of the reading), and the graphs are replayed in
    turns, the order reversed every other round."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # build, set attributes, allocate: outside the capture
        for fn in contenders.values():
            for i in range(n):
                fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs = {}
    for name, fn in contenders.items():
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(cycles):
                for i in range(n):
                    fn(i)
        graphs[name] = g
    for g in graphs.values():
        g.replay()
    torch.cuda.synchronize()
    times = {name: [] for name in graphs}
    for r in range(reps):
        for name in (list(graphs) if r % 2 == 0 else list(graphs)[::-1]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[name].replay()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / (cycles * n))
    del graphs
    torch.cuda.synchronize()
    return {name: statistics.median(t) for name, t in times.items()}


def device_us(fn, n: int, calls: int) -> dict:
    """Mean device microseconds per call of each kernel ``fn`` launches,
    rotating over pools 0..n-1: the profiler's kernel durations, without
    the gaps between launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(calls):
            fn(k % n)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = next((r for r in RAGGED_NAMES if r in e.key), e.key[:60])
            out[name] = out.get(name, 0.0) + e.self_device_time_total / calls
    return out


def dense_kv(q, kv, bs, n_blocks):
    """SDPA's operands for the yardstick: each lane's first ``n_blocks``
    blocks gathered dense and dequantised, heads first."""
    B = q.shape[0]
    rows = (kv.table[:, :n_blocks].long()[:, :, None] * bs
            + torch.arange(bs, device="cuda")).reshape(B, n_blocks * bs)
    dense_k = kv.k[rows].float() * (1 if kv.k_scale is None else kv.k_scale[rows][..., None])
    dense_v = kv.v[rows].float() * (1 if kv.v_scale is None else kv.v_scale[rows][..., None])
    return (dense_k.to(q.dtype).transpose(1, 2).contiguous(),
            dense_v.to(q.dtype).transpose(1, 2).contiguous())


def kernel_phase() -> dict:
    from hypha_tpu_torch.ops.paged_attention import (
        _decode_splits,
        _launch,
        _ragged_route,
        _sm_count,
        ragged_block_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = _sm_count(torch.cuda.current_device())
    bs, max_blocks, blocks = 16, 64, 512  # the 7B pool: max_len 1024, 512 blocks
    cases = []
    for hq, hkv in ((32, 32), (32, 8)):
        for sq in (1, 16, 64):
            for quant in (False, True):
                cases.append(dict(hq=hq, hkv=hkv, sq=sq, quant=quant, window=None, k_start=None))
    for hq, hkv, sq, quant in ((32, 8, 64, False), (32, 8, 64, True), (32, 8, 1, False),
                               (32, 8, 1, True), (32, 32, 1, False), (32, 32, 1, True)):
        cases.append(dict(hq=hq, hkv=hkv, sq=sq, quant=quant, window=100, k_start=[0, 37, 5, 0]))
    cases.append(dict(hq=28, hkv=4, sq=1, quant=False, window=None, k_start=None))  # Qwen2-7B
    # The prefix cache's inputs: a chunk past a cached prefix whose blocks
    # another lane's table maps too (``shared_prefix_case``).
    for quant in (False, True):
        cases.append(dict(hq=32, hkv=32, sq=64, quant=quant, window=None, k_start=None,
                          shared_blocks=SHARED_BLOCKS, q_offset=list(SHARED_QOFF)))
    results, max_err = [], 0.0
    for c in cases:
        occupancy = [9, 40, 0, 64]  # partial, partial, idle lane 2, full
        if "shared_blocks" in c:
            q, kv, qoff, unreachable = shared_prefix_case(gen, quant=c["quant"])
        else:
            q, kv, qoff, unreachable = paged_case(
                gen, B=4, sq=c["sq"], hq=c["hq"], hkv=c["hkv"], D=128, bs=bs,
                max_blocks=max_blocks, blocks=blocks, occupancy=occupancy,
                quant=c["quant"], idle=(2,),
            )
        kst = None if c["k_start"] is None else torch.tensor(c["k_start"], dtype=torch.int32, device="cuda")
        kw = dict(blocks=blocks, block_size=bs, q_offset=qoff, k_start=kst, window=c["window"])
        # Sq 1 runs every route; the decode route with its own split count
        # (the merge kernel) and with one split (no merge).
        routes = {"simt": ("simt", None), "mma": ("mma", None)}
        if c["sq"] == 1:
            routes = {"decode": ("decode", None), "decode_1split": ("decode", 1), **routes}

        def run(route, n):
            return _launch(q, kv, route, splits=n, **kw)

        ref = ragged_block_attention(q, kv, **kw)
        got = {name: run(*rs) for name, rs in routes.items()}
        second = {name: run(*rs) for name, rs in routes.items()}
        torch.cuda.synchronize()
        # Re-poison everything no lane may read: the output bits must stay.
        kv.k[unreachable] = kv.k[unreachable] * -3 + 1
        kv.v[unreachable] = kv.v[unreachable] * 2 - 5
        r = dict(c, main_route=_ragged_route(c["sq"], q.dtype), tol=TOL[torch.bfloat16])
        if c["sq"] == 1:
            r["decode_splits"] = _decode_splits(4, c["hkv"], max_blocks, bs, sms)
        ok = True
        for name, out in got.items():
            err = (out.float() - ref.float()).abs().max().item()
            again = run(*routes[name])
            torch.cuda.synchronize()
            r[name] = dict(max_abs_err=err, idle_zero=bool(torch.all(out[2] == 0)),
                           rerun_bit_identical=bool(torch.equal(out, second[name])),
                           poison_bit_invariant=bool(torch.equal(out, again)))
            ok = ok and err <= TOL[torch.bfloat16] and all(v for k, v in r[name].items()
                                                            if k != "max_abs_err")
            max_err = max(max_err, err)
        r["ok"] = ok
        results.append(r)
        if not ok:
            emit({"phase": "kernels", "failed_case": r})
            raise SystemExit("kernel disagrees with its plain version")

    # Time at the 7B serving shape: 8 lanes, 512 occupied positions each,
    # queries at the end (decode: 1, prefill chunks: 16 and 64). Decode
    # reads 8.4-67 MB a call, within reach of the 50 MB L2, while the serve
    # path finds each layer's pool cold (31 other layers' weights stream
    # between two visits): so every route and SDPA are timed L2-cold,
    # rotating over independent pools (each with its own table) that
    # together hold >= COLD_BYTES, and warm on one pool for comparison.
    timing = {}
    for label, quant, sq, hkv in (("decode_bf16", False, 1, 32), ("decode_int8", True, 1, 32),
                                  ("decode_gqa8_bf16", False, 1, 8),
                                  ("prefill16_bf16", False, 16, 32),
                                  ("prefill64_bf16", False, 64, 32),
                                  ("prefill64_int8", True, 64, 32)):
        B, hq, D = 8, 32, 128
        keys = 32 * bs
        kv_bytes = 2 * B * keys * hkv * D * (1 if quant else 2) + (2 * B * keys * hkv * 4 if quant else 0)
        n_pools = max(2, -(-int(COLD_BYTES) // kv_bytes)) if sq == 1 else 1
        pools = [paged_case(gen, B=B, sq=sq, hq=hq, hkv=hkv, D=D, bs=bs, max_blocks=max_blocks,
                            blocks=blocks, occupancy=[32] * B, quant=quant)
                 for _ in range(n_pools)]
        q, kv, qoff, _ = pools[0]
        # An explicit k_start, as the model passes: with None the wrapper
        # would fill a zero tensor, one more kernel inside each timed call.
        kw = dict(blocks=blocks, block_size=bs,
                  k_start=torch.zeros((B,), dtype=torch.int32, device="cuda"))
        mask = None if sq == 1 else causal_tail(sq, keys)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        main = _ragged_route(sq, q.dtype)
        plain_ms = time_ms(lambda: ragged_block_attention(q, kv, q_offset=qoff, **kw), reps=3, iters=5)
        row = dict(route=main, plain_ms=plain_ms)
        if sq == 1:
            dense = [dense_kv(p[0], p[1], bs, 32) for p in pools]
            qh = [p[0].transpose(1, 2).contiguous() for p in pools]

            def route(name, n=None):
                return lambda i: _launch(pools[i][0], pools[i][1], name, q_offset=pools[i][2],
                                         splits=n, **kw)

            splits = _decode_splits(B, hkv, max_blocks, bs, sms)
            contenders = {"decode": route("decode"), "simt": route("simt"), "mma": route("mma"),
                          "sdpa": lambda i: sdpa(qh[i], *dense[i], enable_gqa=hq != hkv)}
            for n in SPLIT_SWEEP:
                if n != splits:
                    contenders[f"decode_{n}split"] = route("decode", n)
            cold = graph_turns(contenders, n_pools, cycles=max(1, 24 // n_pools))
            warm = graph_turns({k: contenders[k] for k in ("decode", "simt", "mma", "sdpa")}, 1,
                               cycles=20)
            route_ms = {k: cold[k] for k in ("decode", "simt", "mma")}
            library_ms = cold["sdpa"]
            row["device_us"] = {k: device_us(contenders[k], n_pools, 24) for k in ("decode", "sdpa")}
            row.update(decode_ms=cold["decode"], decode_splits=splits,
                       decode_ms_by_splits={n: cold["decode" if n == splits else f"decode_{n}split"]
                                            for n in sorted({*SPLIT_SWEEP, splits})},
                       warm_ms={"decode": warm["decode"], "simt": warm["simt"], "mma": warm["mma"],
                                "sdpa": warm["sdpa"]},
                       pools=n_pools, cycle_bytes=n_pools * kv_bytes)
            del dense, qh
        else:
            other = "simt" if main == "mma" else "mma"
            route_ms = {main: time_ms(lambda: _launch(q, kv, main, q_offset=qoff, **kw))}
            route_ms[other] = time_ms(lambda: _launch(q, kv, other, q_offset=qoff, **kw))
            qh = q.transpose(1, 2).contiguous()
            kh, vh = dense_kv(q, kv, bs, 32)
            library_ms = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask, enable_gqa=hq != hkv))
        io_bytes = kv_bytes + 2 * q.numel() * q.element_size() + kv.table.numel() * 4 + 2 * B * 4
        # Visible (query, key) pairs: query i of sq sits at position
        # keys - sq + i and sees keys up to it (causal).
        pairs = B * hq * sum(keys - sq + 1 + i for i in range(sq))
        ops = 4 * D * pairs
        t_bytes = io_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[torch.bfloat16] * 1e3
        bound = max(t_bytes, t_ops)
        row.update(ms=route_ms[main], mma_ms=route_ms["mma"], simt_ms=route_ms["simt"],
                   library_ms=library_ms, bound_ms=bound,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   share_of_bound=bound / route_ms[main], bytes=io_bytes, ops=ops,
                   achieved_GBps=io_bytes / route_ms[main] / 1e6,
                   achieved_TFLOPs=ops / route_ms[main] / 1e9)
        timing[label] = row
        del pools, q, kv
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "cases": results, "timing": timing,
          "shape": "B=8 Hq=32 Hkv=32 (gqa8: 8) D=128 bs=16, 512 occupied positions per lane",
          "routes": "Sq 1: decode (split-KV, GQA-packed, f32 CUDA cores), simt, mma; "
                    "Sq 16/64: simt and mma; decode timed L2-cold, prefill warm"})
    return {"max_abs_err": max_err, "timing": timing}


def causal_tail(sq: int, keys: int) -> torch.Tensor:
    """Bool mask for sq queries at the last sq of ``keys`` positions."""
    qi = torch.arange(keys - sq, keys, device="cuda")[:, None]
    return qi >= torch.arange(keys, device="cuda")[None, :]


# -------------------------------------------------------------- serve phase


def make_prompts(seed: int, lengths: list, vocab: int = 32_000) -> list:
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(3, vocab, (n,), generator=g).tolist() for n in lengths]


async def drive(server, prompts: list, n_new: list) -> list:
    return await asyncio.gather(*(
        server.submit([p], n, 0.0, None, 0) for p, n in zip(prompts, n_new)
    ))


def serve_phase(model, *, kv_quant: str, lengths: list, n_new: list) -> dict:
    from hypha_tpu_torch.ops.paged_attention import paged_attention, ragged_paged_attention
    from hypha_tpu_torch.worker.continuous import PoolServer
    from hypha_tpu_torch.worker.infer_executor import generate_grouped

    def fallback(prompts, n, temperature, top_k, seed):
        return generate_grouped(model, prompts, n, temperature, top_k, seed)

    prompts = make_prompts(len(lengths) + len(kv_quant), lengths)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    async def run():
        server = PoolServer(model, fallback, slots=8, max_len=1024, steps_per_call=8,
                            block_size=16, ragged=True, kv_quant=kv_quant)
        try:
            ragged_paged_attention.launches = 0
            for name in ROUTES:
                setattr(ragged_paged_attention, f"{name}_launches", 0)
            paged_attention.plain_calls = 0
            t0 = time.perf_counter()
            out = await drive(server, prompts, n_new)
            wall = time.perf_counter() - t0
            launches = ragged_paged_attention.launches
            by_route = {name: getattr(ragged_paged_attention, f"{name}_launches") for name in ROUTES}
            plain = paged_attention.plain_calls
            stats = dict(server.pool.stats)
            pool = server.pool
            forwards = {"prefill": pool.prefill_chunks, "decode": pool.chunks * pool.steps_per_call}
            again = await drive(server, prompts[:2], n_new[:2])
            return server, out, wall, launches, by_route, plain, stats, forwards, again
        finally:
            server.close()

    server, out, wall, launches, by_route, plain, stats, forwards, again = asyncio.run(run())
    for toks, n in zip(out, n_new):
        if len(toks) != 1 or len(toks[0]) != n:
            raise SystemExit(f"request answered with {len(toks[0])} tokens, wanted {n}")
    if again != out[:2]:
        raise SystemExit("a repeated request returned different tokens")
    # Prefill chunks take the mma route and decode steps the decode route,
    # each once per layer per forward; simt serves neither (bf16 q, chunks
    # of 1 or of the pool's prefill width).
    layers = model.config.num_layers
    if (launches <= 0 or by_route["mma"] <= 0 or by_route["decode"] <= 0 or plain != 0
            or by_route["mma"] % layers or by_route["decode"] % layers):
        raise SystemExit(f"kernel launches {launches} {by_route} (layers {layers}), "
                         f"plain attention calls {plain}")
    if server.fallbacks:
        raise SystemExit("a request left the pool for the one-shot fallback")
    res = dict(
        kv_quant=kv_quant or "bf16", requests=len(prompts), prompt_lengths=lengths,
        n_new=n_new, wall_s=wall, kernel_launches=launches,
        kernel_launches_by_route=by_route, plain_attention_calls=plain, forwards=forwards,
        decode_chunks=server.pool.chunks, prefill_chunks=server.pool.prefill_chunks,
        preemptions=server.pool.preemptions,
        prefill_tok_s=stats["prefill_tokens"] / stats["prefill_s"],
        decode_tok_s=stats["decode_tokens"] / stats["decode_s"],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        repeat_identical=True, **stats,
    )
    # For serve_node (main keeps them out of the phase's line).
    res.update(prompts=prompts, answers=out, layers=layers)
    return res


# ---------------------------------------------------------- serve_node phase

# The ``serve`` phase's pool as a scheduler's serve job: 8 slots, blocks of
# 16 (512 of them, derived), the ragged kernel, 64 new tokens at most; the
# executor derives max_len 1024 and a decode chunk of 8.
SERVE_NAME = "llama7b"
# The serving phases over the network (serve_node, serve_router,
# serve_fleet) load 8 of the 32 layers, at full width: their gates are the
# network's, and their host-bound decode costs ~80 launches a layer per
# forward. Their in-process references run at the same depth (main).
CLI_LAYERS = 8
CLI_MODEL = {"family": "llama", "preset": "llama2-7b", "seed": 0,
             "config": {"num_layers": CLI_LAYERS}}
SERVE_JOB = {"job.kind": "serve", "job.serve_name": SERVE_NAME, "job.model_family": "llama",
             "job.model_preset": "llama2-7b", "job.model_type": "causal-lm",
             "job.model_seed": 0, "job.model_config": {"num_layers": CLI_LAYERS},
             "job.serve_max_batch": 8, "job.serve_block_size": 16,
             "job.serve_blocks": 0, "job.serve_ragged": True, "job.serve_max_new_tokens": 64}
NODE_WAIT_S = 300.0  # every wait of the phase: bring-up, each request
STOP_WAIT_S = 30.0  # each process must exit within this after SIGTERM
SERVE_ROLES = ("gateway", "worker", "scheduler")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _log_time(line: str) -> float:
    """The wall-clock time of a log line (the CLI's ``%(asctime)s``)."""
    return datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f").timestamp()


async def _wait_for_text(path: Path, text: str, proc, deadline: float) -> None:
    loop = asyncio.get_running_loop()
    while text not in path.read_text(errors="replace"):
        if proc.returncode is not None:
            raise SystemExit(f"{path.name}: exited {proc.returncode} before {text!r}:\n"
                             f"{path.read_text(errors='replace')[-4000:]}")
        if loop.time() > deadline:
            raise SystemExit(f"{path.name}: no {text!r} within {NODE_WAIT_S} s")
        await asyncio.sleep(0.1)


def run_inits(cli: list, outputs: dict, *, env: dict, cwd: str) -> None:
    """``<cli> <role> init -o <path>`` for each role, the processes at once
    (each spends its seconds importing torch); raises on any failure."""
    procs = {role: subprocess.Popen([*cli, role, "init", "-o", str(path)], env=env, cwd=cwd,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for role, path in outputs.items()}
    for role, proc in procs.items():
        out, _ = proc.communicate(timeout=60)
        if proc.returncode:
            raise subprocess.CalledProcessError(proc.returncode, proc.args, out)


def _toml_value(value) -> str:
    """A ``--set`` value as TOML reads it (tables inline)."""
    if isinstance(value, dict):
        return "{" + ", ".join(f"{k} = {_toml_value(v)}" for k, v in value.items()) + "}"
    return json.dumps(value)


class ServeNet:
    """The quickstart as processes: ``gateway``, one or more workers and a
    ``scheduler``, each ``python -m hypha_tpu_torch <role> run -c ...
    --set ...`` from a TOML the port's ``init`` wrote (the gateway on a free
    port of 127.0.0.1; each worker offering its whole GPU from a work root
    of its own under ``root/work``, with ``--device`` when given; the
    scheduler running ``job``), each logging to ``root/<role>.log``, and a
    client ``Node`` bootstrapped at the gateway. With ``trace_dir`` each
    process traces there under its role's name (``HYPHA_TRACE_DIR``,
    ``HYPHA_TRACE_NODE``); with ``otlp`` each exports to that endpoint
    (``telemetry.endpoint``)."""

    def __init__(self, root: Path, job: dict, workers: dict, device: "str | None",
                 trace_dir: "Path | None" = None, otlp: "str | None" = None) -> None:
        self.root, self.job, self.device = root, job, device
        self.trace_dir, self.otlp = trace_dir, otlp
        self.workers = workers  # role -> worker name
        self.roles = ("gateway", *workers, "scheduler")
        self.repo = os.path.dirname(os.path.abspath(__file__))
        self.env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (self.repo, os.environ.get("PYTHONPATH", "")) if p)}
        self.cli = [sys.executable, "-m", "hypha_tpu_torch"]
        self.work = root / "work"
        self.procs, self.logs, self.files = {}, {}, []
        self.exits, self.stop_s = {}, {}
        self.client = None

    def init(self) -> None:
        """Write each role's TOML with ``init`` (not timed as bring-up)."""
        run_inits(self.cli, {role: self.root / f"{role}.toml"
                             for role in ("gateway", "worker", "scheduler")},
                  env=self.env, cwd=self.repo)

    async def start(self) -> None:
        """Start every process and the client (after :meth:`init`)."""
        gateway = f"127.0.0.1:{_free_port()}"
        self.work.mkdir()
        loop = asyncio.get_running_loop()
        for role in self.roles:
            kind = role if role in ("gateway", "scheduler") else "worker"
            sets = {"gateway": {"network.listen": [gateway]},
                    "scheduler": {**self.job, "network.gateways": [gateway]}}.get(kind)
            flags = []
            if kind == "worker":
                sets = {"resources.gpu": 1, "resources.cpu": 8, "resources.memory": 65536,
                        "offer.strategy": "whole", "work_root": str(self.work / role),
                        "network.gateways": [gateway]}
                flags = ["--name", self.workers[role]] + (
                    ["--device", self.device] if self.device else [])
            env = self.env
            if self.trace_dir is not None:
                env = {**env, "HYPHA_TRACE_DIR": str(self.trace_dir),
                       "HYPHA_TRACE_NODE": self.workers.get(role, role)}
            if self.otlp is not None:
                sets = {**sets, "telemetry.endpoint": self.otlp}
            args = [*self.cli, kind, "run", "-c", str(self.root / f"{kind}.toml"), *flags]
            for key, value in sets.items():
                args += ["--set", f"{key}={_toml_value(value)}"]
            self.logs[role] = self.root / f"{role}.log"
            self.files.append(open(self.logs[role], "wb"))
            self.procs[role] = await asyncio.create_subprocess_exec(
                *args, stdout=self.files[-1], stderr=subprocess.STDOUT, env=env,
                cwd=self.repo)
            if role == "gateway":
                await _wait_for_text(self.logs[role], "gateway gateway on", self.procs[role],
                                     loop.time() + NODE_WAIT_S)
        from hypha_tpu_torch.network import Node, TcpTransport

        self.client = Node(TcpTransport(), peer_id="client", bootstrap=[gateway])
        await self.client.start(["127.0.0.1:0"])
        await self.client.wait_for_bootstrap()

    def check_alive(self, during: str) -> None:
        for role, p in self.procs.items():
            if p.returncode is not None and role not in self.exits:
                raise SystemExit(f"{role} exited {p.returncode} during {during}:\n"
                                 f"{self.text(role)[-4000:]}")

    async def wait_for_provider(self, name: str) -> None:
        from hypha_tpu_torch.worker.infer_executor import serve_key

        deadline = asyncio.get_running_loop().time() + NODE_WAIT_S
        while not await self.client.find_providers(serve_key(name)):
            self.check_alive("bring-up")
            if asyncio.get_running_loop().time() > deadline:
                raise SystemExit(f"serve:{name} did not resolve within {NODE_WAIT_S} s")
            await asyncio.sleep(0.1)

    async def kill(self, role: str) -> None:
        """SIGKILL, as a crash would end the process."""
        p = self.procs[role]
        p.send_signal(signal.SIGKILL)
        self.exits[role] = await p.wait()
        self.stop_s[role] = 0.0

    async def stop(self) -> None:
        """The client, then SIGTERM to the scheduler, the workers and the
        gateway in turn, each given ``STOP_WAIT_S``."""
        if self.client is not None:
            await self.client.stop()
        for role in reversed(self.roles):
            p = self.procs.get(role)
            if p is None or role in self.exits:
                continue
            t = time.perf_counter()
            if p.returncode is None:
                p.send_signal(signal.SIGTERM)
            try:
                self.exits[role] = await asyncio.wait_for(p.wait(), STOP_WAIT_S)
            except asyncio.TimeoutError:
                p.kill()
                await p.wait()
                self.exits[role] = "killed"
            self.stop_s[role] = time.perf_counter() - t
        for f in self.files:
            f.close()

    def text(self, role: str) -> str:
        return self.logs[role].read_text(errors="replace")

    def worker_report(self, role: str) -> dict:
        """What a worker logged: its last launch and cache counts, its
        serving peak, the load's seconds and peak, its kernel builds."""
        lines = self.text(role).splitlines()

        def last_json(tag):
            found = [json.loads(line.split(tag, 1)[1]) for line in lines if tag in line]
            return found[-1] if found else None

        peak = [float(line.split("peak device memory: ", 1)[1].split()[0])
                for line in lines if "peak device memory: " in line]
        # "job J model loaded in S s[, peak device memory P GiB]"
        loaded = [re.findall(r"[\d.]+(?= s\b| GiB)", line.split("model loaded in ", 1)[1])
                  for line in lines if "model loaded in " in line]
        return dict(
            launches=last_json("serve launches: "), cache=last_json("serve cache: "),
            peak_mem_gib=peak[-1] if peak else None,
            load_s=float(loaded[0][0]) if loaded else None,
            load_peak_mem_gib=float(loaded[0][1]) if loaded and len(loaded[0]) > 1 else None,
            kernel_builds=[line.split("kernel library ", 1)[1] for line in lines
                           if "kernel library " in line],
        )

    def leftover(self, skip=()) -> list:
        return sorted(str(p.relative_to(self.work)) for p in self.work.rglob("*")
                      if p.relative_to(self.work).parts[0] not in skip
                      and p != self.work / p.relative_to(self.work).parts[0])


async def _timed_ask(client, name: str, prompt: list, n: int) -> tuple:
    from hypha_tpu_torch.worker.infer_executor import generate_remote

    t = time.perf_counter()
    toks = await generate_remote(client, name, [prompt], n, timeout=NODE_WAIT_S)
    return toks, time.perf_counter() - t, time.time()


async def run_serve_node(root: Path, job: dict, prompts: list, n_new: list, *,
                         device: "str | None" = None, repeat: int = 2) -> dict:
    """``ServeNet`` with one worker, ``w0``: the client sends each prompt
    with its ``n_new`` as a request of its own, all at once, through
    ``generate_remote``, then the first ``repeat`` again; then every
    process stops. Every wait has a deadline. Returns the answers, the
    timings, the exit codes and what the worker logged."""
    from hypha_tpu_torch.worker.infer_executor import generate_remote

    name = job["job.serve_name"]
    net = ServeNet(root, job, {"worker": "w0"}, device)
    net.init()
    t0 = time.perf_counter()
    try:
        await net.start()
        await net.wait_for_provider(name)
        bring_up_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        got = await asyncio.wait_for(asyncio.gather(*(
            _timed_ask(net.client, name, p, n) for p, n in zip(prompts, n_new))), NODE_WAIT_S)
        wall_s = time.perf_counter() - t1
        again = await asyncio.wait_for(asyncio.gather(*(
            generate_remote(net.client, name, [p], n, timeout=NODE_WAIT_S)
            for p, n in zip(prompts[:repeat], n_new[:repeat]))), NODE_WAIT_S)
    finally:
        await net.stop()
    dispatched = [_log_time(line) for line in net.text("scheduler").splitlines()
                  if f"serving {name} slot 0 deployed on" in line]
    latencies = sorted(lat for _, lat, _ in got)
    report = net.worker_report("worker")
    return dict(
        answers=[toks for toks, _, _ in got], again=again, bring_up_s=bring_up_s,
        dispatch_to_first_answer_s=(min(at for _, _, at in got) - dispatched[0]
                                    if dispatched else None),
        latency_s=[lat for _, lat, _ in got], latency_median_s=statistics.median(latencies),
        latency_max_s=latencies[-1], wall_s=wall_s, exits=net.exits, stop_s=net.stop_s,
        **{k: report[k] for k in ("launches", "peak_mem_gib", "load_s", "load_peak_mem_gib",
                                  "kernel_builds")},
        leftover=net.leftover(), logs={role: str(path) for role, path in net.logs.items()},
    )


def launch_problems(who: str, lc, kernel_builds: list, *, layers: int, device: str) -> list:
    """A worker's launch gates: its launches line with mma and decode
    launches, each a multiple of ``layers``, and no plain call on the card
    (on the CPU only plain calls); no one-shot fallback; on the card, no
    kernel built anew."""
    problems = []
    if not isinstance(lc, dict):
        problems.append(f"want a serve launches line from {who}, got {lc}")
    elif device == "cuda":
        if (lc["mma"] <= 0 or lc["decode"] <= 0 or lc["mma"] % layers or lc["decode"] % layers
                or lc["plain"] != 0):
            problems.append(f"{who}: launches {lc} (layers {layers})")
    elif lc["plain"] <= 0 or lc["mma"] or lc["decode"] or lc["simt"]:
        problems.append(f"{who}: launches {lc} on the CPU")
    if isinstance(lc, dict) and lc["fallbacks"]:
        problems.append(f"{who}: {lc['fallbacks']} requests left the pool for the fallback")
    if device == "cuda" and (not kernel_builds
                             or any(b.split(": ", 1)[1] != "cached" for b in kernel_builds)):
        problems.append(f"{who} built kernels anew: {kernel_builds}")
    return problems


def exit_problems(run: dict, roles) -> list:
    """Each of ``roles`` out with 0 within ``STOP_WAIT_S`` of SIGTERM."""
    return [f"{role} exited {run['exits'].get(role)} after {run['stop_s'].get(role)} s of SIGTERM"
            for role in roles
            if run["exits"].get(role) != 0 or run["stop_s"].get(role, STOP_WAIT_S) >= STOP_WAIT_S]


def serve_node_problems(run: dict, *, want: list, n_new: list, layers: int, device: str) -> list:
    """The gates of the serve_node phase: every request answered with its
    ``n_new`` tokens, equal to ``want`` (the in-process pool's answers) and
    the repeats equal; the worker's launch gates (``launch_problems``);
    every process out with 0 within ``STOP_WAIT_S`` and nothing left in the
    work root."""
    problems = []
    for i, (toks, n) in enumerate(zip(run["answers"], n_new)):
        if len(toks) != 1 or len(toks[0]) != n:
            problems.append(f"request {i} answered {[len(t) for t in toks]} tokens, wanted {n}")
    if run["answers"] != want:
        problems.append("the network's answers differ from the in-process pool's")
    if run["again"] != run["answers"][:len(run["again"])]:
        problems.append("a repeated request returned different tokens")
    problems += launch_problems("the worker", run["launches"], run["kernel_builds"],
                                layers=layers, device=device)
    problems += exit_problems(run, SERVE_ROLES)
    if run["leftover"]:
        problems.append(f"left in the work root: {run['leftover']}")
    return problems


def serve_node_phase(serve: dict) -> dict:
    """``serve``'s requests through a gateway, a worker and a scheduler,
    each a process of its own started from TOML by the port's CLI."""
    root = Path(tempfile.mkdtemp(prefix="hsn"))
    try:
        run = asyncio.run(run_serve_node(root, SERVE_JOB, serve["prompts"], serve["n_new"]))
        problems = serve_node_problems(run, want=serve["answers"], n_new=serve["n_new"],
                                       layers=serve["layers"], device="cuda")
        if problems:
            logs = {r: Path(p).read_text(errors="replace")[-3000:] for r, p in run["logs"].items()}
            raise SystemExit(f"serve_node: {problems}\n{json.dumps(logs, indent=1)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    keep = ("bring_up_s", "dispatch_to_first_answer_s", "latency_s", "latency_median_s",
            "latency_max_s", "wall_s", "stop_s", "exits", "launches", "peak_mem_gib",
            "load_s", "load_peak_mem_gib", "kernel_builds")
    return dict(requests=len(serve["prompts"]), serve_wall_s=serve["wall_s"],
                network_share=1.0 - serve["wall_s"] / run["wall_s"],
                answers_equal_serve=True, repeat_identical=True,
                **{k: run[k] for k in keep})


# ------------------------------------------------ serve_prefix phase

PREFIX_LEN = 320  # the shared prompt prefix of a family of requests
PREFIX_SEED = 11


def prefix_requests(seed: int = PREFIX_SEED) -> tuple:
    """16 greedy requests: 4 families of 4 prompts, each family sharing a
    ``PREFIX_LEN``-token prefix drawn from the seed, with distinct tails of
    17-150 tokens and 32-64 new tokens. Family 0's first prompt (320 + 32
    tokens, a multiple of 16) comes again as the ninth request, while the
    first is still decoding: its fully cached prompt recomputes its last
    token inside a block the first still maps (copy-on-write)."""
    prefixes = make_prompts(seed, [PREFIX_LEN] * 4)
    tails = make_prompts(seed + 1, [32, 17, 64, 150, 45, 99, 23, 80, 130, 57, 111, 38, 71, 140,
                                    29, 150])
    fam = [[prefixes[f] + tails[4 * f + m] for m in range(4)] for f in range(4)]
    order = [(0, 0), (1, 0), (2, 0), (3, 0), (0, 1), (1, 1), (2, 1), (3, 1),
             (0, 0), (1, 2), (2, 2), (3, 2), (0, 2), (1, 3), (2, 3), (3, 3)]
    prompts = [fam[f][m] for f, m in order]
    n_new = [64, 32, 40, 48, 56, 36, 44, 52, 64, 60, 32, 40, 48, 56, 36, 44]
    return prompts, n_new


def _pool_run(model, prompts, n_new, **pool) -> dict:
    """The requests through ``PoolServer`` over a paged, ragged pool of
    ``serve``'s shape, all at once; the launch counts set to 0 just before
    and read just after."""
    from hypha_tpu_torch.ops.paged_attention import paged_attention, ragged_paged_attention
    from hypha_tpu_torch.worker.continuous import PoolServer
    from hypha_tpu_torch.worker.infer_executor import generate_grouped

    def fallback(prompts, n, temperature, top_k, seed):
        return generate_grouped(model, prompts, n, temperature, top_k, seed)

    async def run():
        server = PoolServer(model, fallback, slots=8, max_len=1024, steps_per_call=8,
                            block_size=16, ragged=True, **pool)
        try:
            for name in ROUTES:
                setattr(ragged_paged_attention, f"{name}_launches", 0)
            ragged_paged_attention.launches = 0
            paged_attention.plain_calls = 0
            t0 = time.perf_counter()
            out = await drive(server, prompts, n_new)
            wall = time.perf_counter() - t0
            by_route = {name: getattr(ragged_paged_attention, f"{name}_launches")
                        for name in ROUTES}
            return server, out, wall, by_route, paged_attention.plain_calls
        finally:
            server.close()

    server, out, wall, by_route, plain = asyncio.run(run())
    pool_ = server.pool
    return dict(answers=[o[0] for o in out], wall_s=wall, launches_by_route=by_route,
                plain_attention_calls=plain, fallbacks=server.fallbacks,
                prefill_forwards=pool_.prefill_chunks, decode_chunks=pool_.chunks,
                preemptions=pool_.preemptions, hit_blocks=pool_.hit_blocks,
                miss_blocks=pool_.miss_blocks, cow_copies=pool_.cow_copies)


def divergence(model, prompt: list, got: list, want: list) -> dict:
    """Where two greedy streams of one prompt first differ, and the gap
    between the top two logits of the full (training) forward there."""
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    with torch.inference_mode():
        ids = torch.tensor([prompt + want[:i]], device=model.device)
        top = model(ids)[0, -1].float().topk(2)
    return dict(position=i, got=got[i], want=want[i],
                top2=top.indices.tolist(), top2_gap=float(top.values[0] - top.values[1]))


def serve_prefix_phase(model) -> dict:
    """``prefix_requests`` through ``serve``'s pool with the prefix cache on
    and off, in bf16 and with int8 KV blocks. Gates: answers equal with
    the cache on and off, hit blocks and copy-on-writes above 0, fewer
    prefill forwards with the cache, launches in multiples of the layers
    on the mma and decode routes, no plain attention call, no fallback."""
    prompts, n_new = prefix_requests()
    layers = model.config.num_layers
    runs = {}
    for quant in ("", "int8"):
        for cache in (True, False):
            runs[(quant, cache)] = _pool_run(model, prompts, n_new, kv_quant=quant,
                                             prefix_cache=cache)
    for quant in ("", "int8"):
        on, off = runs[(quant, True)], runs[(quant, False)]
        label = quant or "bf16"
        if on["answers"] != off["answers"]:
            bad = [i for i, (a, b) in enumerate(zip(on["answers"], off["answers"])) if a != b]
            where = divergence(model, prompts[bad[0]], on["answers"][bad[0]],
                               off["answers"][bad[0]])
            emit({"phase": "serve_prefix", "failed": label, "requests": bad, "first": where})
            raise SystemExit(f"serve_prefix {label}: the cache changed the tokens of {bad}")
        for i, (toks, n) in enumerate(zip(on["answers"], n_new)):
            if len(toks) != n:
                raise SystemExit(f"serve_prefix {label}: request {i} got {len(toks)} tokens")
        if on["hit_blocks"] <= 0 or on["cow_copies"] <= 0:
            raise SystemExit(f"serve_prefix {label}: hits {on['hit_blocks']}, "
                             f"copy-on-writes {on['cow_copies']}")
        if on["prefill_forwards"] >= off["prefill_forwards"]:
            raise SystemExit(f"serve_prefix {label}: {on['prefill_forwards']} prefill forwards "
                             f"with the cache, {off['prefill_forwards']} without")
        for run in (on, off):
            lc = run["launches_by_route"]
            if (lc["mma"] <= 0 or lc["decode"] <= 0 or lc["mma"] % layers
                    or lc["decode"] % layers or run["plain_attention_calls"] or run["fallbacks"]):
                raise SystemExit(f"serve_prefix {label}: launches {lc}, plain "
                                 f"{run['plain_attention_calls']}, fallbacks {run['fallbacks']}")
    keep = ("wall_s", "prefill_forwards", "decode_chunks", "preemptions", "hit_blocks",
            "miss_blocks", "cow_copies", "launches_by_route")
    res = {f"{quant or 'bf16'}_{'cache' if cache else 'nocache'}": {k: r[k] for k in keep}
           for (quant, cache), r in runs.items()}
    res.update(requests=len(prompts), prefix_len=PREFIX_LEN, n_new=n_new,
               prompt_lengths=[len(p) for p in prompts], answers_equal_uncached=True,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    # For serve_router (main keeps them out of the phase's line).
    res.update(prompts=prompts, answers=runs[("", True)]["answers"], layers=layers)
    return res


# ------------------------------------------------------ serve_spec phase

# Speculative decoding and the fixed-slot pool in process, on the 8-layer
# model: 8 slots, blocks of 16, prefill chunks of 64 (the verify's width).
SPEC_POOL = dict(slots=8, max_len=1024, steps_per_call=8, block_size=16, prefill_chunk=64,
                 ragged=True)
SPEC_NGRAM = 3
SPEC_LAYERS = 2
SPEC_DRAFT = 7  # the self-draft's tokens a verify: its window keeps 57 context tokens
SPEC_SEED = 31
SPEC_F32_REQUESTS = 4  # the f32 runs take the first four requests, 32 new tokens each
SPEC_F32_NEW = 32
# The settled traffic: contexts cut 8 tokens into a stretch of at least
# SPEC_SETTLED tokens of a spec-off answer that repeat with a period of at
# most 4, asking for what remains of the stretch (at most SPEC_SETTLED_NEW).
SPEC_SETTLED, SPEC_SETTLED_NEW = 16, 24


def spec_requests(seed: int = SPEC_SEED) -> tuple:
    """8 prompts of a repeated segment (6-16 tokens, 3-12 times) that end
    inside it, so that prompt lookup finds the prompt's last n-gram, and
    48-62 new tokens each."""
    g = torch.Generator().manual_seed(seed)
    prompts, n_new = [], []
    for i in range(8):
        n = int(torch.randint(6, 17, (1,), generator=g))
        seg = torch.randint(3, 32_000, (n,), generator=g).tolist()
        reps = int(torch.randint(3, 13, (1,), generator=g))
        prompts.append(seg * reps + seg[: int(torch.randint(3, n, (1,), generator=g))])
        n_new.append(48 + 2 * i)
    return prompts, n_new


def spec_run(model, prompts: list, n_new: list, *, profiled: bool = False, **pool) -> dict:
    """The requests through one in-process ``DecodePool``, all at once; the
    launch counts set to 0 just before and read just after, and with
    ``profiled`` the ragged kernels' device launches and time."""
    from torch.profiler import ProfilerActivity, profile

    from hypha_tpu_torch.executor.pool import DecodePool
    from hypha_tpu_torch.ops.attention import dot_product_attention
    from hypha_tpu_torch.ops.paged_attention import paged_attention, ragged_paged_attention

    p = DecodePool(model, **{**SPEC_POOL, **pool})
    draft_launches = {"decode": 0, "mma": 0, "simt": 0}
    if p.spec_model:  # count the routes the draft's own forwards take
        draft = p._draft_forward

        def counted(context, cap):
            before = {r: getattr(ragged_paged_attention, f"{r}_launches") for r in ROUTES}
            out = draft(context, cap)
            for r in ROUTES:
                draft_launches[r] += getattr(ragged_paged_attention, f"{r}_launches") - before[r]
            return out

        p._draft_forward = counted
    try:
        for name in ROUTES:
            setattr(ragged_paged_attention, f"{name}_launches", 0)
        paged_attention.plain_calls = dot_product_attention.calls = 0
        prof = profile(activities=[ProfilerActivity.CUDA]) if profiled else nullcontext()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof:
            futs = [p.submit([q], n) for q, n in zip(prompts, n_new)]
            answers = [f.result(timeout=600)[0] for f in futs]
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_route = {name: getattr(ragged_paged_attention, f"{name}_launches") for name in ROUTES}
        plain, dense = paged_attention.plain_calls, dot_product_attention.calls
    finally:
        p.close()
    kernels = None
    if profiled:
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = {name: {"launches": sum(e.count for e in events if name in e.key),
                          "ms": sum(e.self_device_time_total for e in events if name in e.key) / 1e3}
                   for name in RAGGED_NAMES}
    st = p.stats
    emitted = sum(len(a) for a in answers)
    # The target model's forwards, as the pool dispatches them: each
    # prefill-shaped chunk once (a verify shares its chunk with the prefill
    # lanes), and K a decode chunk. Beside them the forwards each lane took
    # part in after its prefill: a decode step yields one token, a verify
    # its accepted drafts and a bonus.
    forwards = p.prefill_chunks + st["spec_only_chunks"] + p.steps_per_call * p.chunks
    lane_forwards = st["decode_lane_steps"] + st["spec_lanes"]
    return dict(answers=answers, wall_s=wall, tok_s=emitted / wall, launches_by_route=by_route,
                draft_launches_by_route=draft_launches if p.spec_model else None,
                plain_attention_calls=plain, dense_attention_calls=dense, kernels=kernels,
                prefill_chunks=p.prefill_chunks, decode_chunks=p.chunks,
                spec_chunks=p.spec_chunks, spec_lanes=st["spec_lanes"], forwards=forwards,
                # Of the lanes' turns after prefill (a verify, or a decode
                # chunk of K steps), the share that proposed.
                lanes_proposing=st["spec_lanes"] / max(
                    st["spec_lanes"] + st["decode_lane_steps"] / p.steps_per_call, 1),
                dispatches_per_token=forwards / emitted, emitted=emitted,
                forwards_per_token=lane_forwards / max(st["decode_tokens"] + st["spec_tokens"], 1),
                spec_proposed=st["spec_proposed"], spec_accepted=st["spec_accepted"],
                accept_rate=st["spec_accepted"] / st["spec_proposed"] if st["spec_proposed"]
                else None,
                decode_tok_s=(st["decode_tokens"] + st["spec_tokens"])
                / max(st["decode_s"] + st["spec_s"], 1e-9),
                # Host-clocked, ending in the chunk's sync: the verifies that
                # carried no prefill lane.
                verify_chunk_ms=st["spec_s"] / st["spec_only_chunks"] * 1e3
                if st["spec_only_chunks"] else None,
                preemptions=p.preemptions)


def spec_echo(prompts: list, answers: list, reps: int = 32) -> list:
    """Each prompt followed by ``reps`` copies of the token its own greedy
    answer repeats most. The seeded model loops on such tokens (its answers
    to ``spec_requests`` repeat a token up to 20 times running on the
    H100), so its continuation is what prompt lookup drafts."""
    return [p + [collections.Counter(a).most_common(1)[0][0]] * reps
            for p, a in zip(prompts, answers)]


def settled_requests(contexts: list, answers: list, lanes: int) -> tuple:
    """Requests on which the seeded model's greedy stream repeats a short
    cycle, so that prompt lookup drafts it for every lane from the first
    step: for each spec-off ``answers[i]`` to ``contexts[i]``, its longest
    stretch that repeats with a period of 1-4 tokens; of those at least
    ``SPEC_SETTLED`` long, the context through 8 tokens of the stretch and
    the stretch's remaining tokens (at most ``SPEC_SETTLED_NEW``) as the
    budget, longest first, cycled to ``lanes`` requests."""
    found = []
    for ctx, a in zip(contexts, answers):
        best = (0, 0)
        for p in range(1, 5):
            run = 0
            for i in range(p, len(a)):
                run = run + 1 if a[i] == a[i - p] else 0
                if run + p > best[0]:
                    best = (run + p, i + 1)  # length, end
        length, end = best
        if length >= SPEC_SETTLED:
            cut = end - length + 8
            found.append((length, ctx + a[:cut], min(end - cut, SPEC_SETTLED_NEW)))
    found.sort(key=lambda f: -f[0])
    picked = [found[i % len(found)] for i in range(lanes)] if found else []
    return [f[1] for f in picked], [f[2] for f in picked], len(found)


def first_divergence(model, prompts: list, got: list, want: list) -> "dict | None":
    """``divergence`` at the first request whose tokens differ (None when
    every request's are equal)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            return {"request": i, **divergence(model, prompts[i], g, w)}
    return None


def serve_spec_phase(model) -> dict:
    """Speculative decoding and the fixed-slot pool on the 8-layer model.
    The echo traffic: ``spec_requests`` answered once with spec off, then
    each prompt extended by ``spec_echo``. The settled traffic
    (``settled_requests``): where the spec-off answers to both settled into
    a short cycle, so that every lane proposes. bf16: on the echo traffic
    spec off, ``spec_ngram`` 3, ``spec_layers`` 2 and a fixed-slot pool,
    timed, and the two spec pools once more under the profiler on two
    requests; on the settled traffic spec off and ``spec_ngram`` 3. f32
    (every route the simt kernel): spec off, ``spec_ngram`` 3 and a
    fixed-slot pool on the first four echo requests. Gates: (a) f32 spec-on
    tokens equal spec-off; (b) every request completes with its count (bf16
    agreement with spec off reported); (c) ``spec_ngram`` accepts drafts on
    both traffics, and on the settled traffic takes fewer target-model
    forwards an emitted token than spec off (the pool's dispatches: a
    prefill-shaped chunk once, a decode chunk K times). On the echo
    traffic, where some lanes find no draft and so a K-step decode chunk
    runs beside most verifies, speculation dispatches more forwards a
    token and is slower: reported, not gated, beside each lane's own
    forwards a token. (d) The verify
    chunks on ``ragged_mma_kernel``, no ``ragged_kernel`` (simt) in a bf16
    run, the self-draft's decode steps on ``ragged_decode_kernel``; (e) the
    f32 fixed-slot tokens equal the paged pool's; (f) no plain paged
    attention and no dense attention in a paged run (the fixed-slot pool's
    attention is the dense one, as the reference's is XLA's)."""
    from hypha_tpu_torch.worker.infer_executor import load_model

    t0 = time.perf_counter()
    seed_prompts, n_new = spec_requests()
    seeded = spec_run(model, seed_prompts, n_new)
    prompts = spec_echo(seed_prompts, seeded["answers"])
    spec = dict(spec_draft=SPEC_DRAFT)
    runs = {"bf16_off": spec_run(model, prompts, n_new),
            "bf16_ngram": spec_run(model, prompts, n_new, spec_ngram=SPEC_NGRAM, **spec),
            "bf16_layers": spec_run(model, prompts, n_new, spec_layers=SPEC_LAYERS, **spec),
            "bf16_fixed": spec_run(model, prompts, n_new, block_size=0, ragged=False,
                                   prefill_chunk=0)}
    settled, settled_new, n_settled = settled_requests(
        seed_prompts + prompts, seeded["answers"] + runs["bf16_off"]["answers"], len(prompts))
    if settled:
        runs.update(bf16_settled_off=spec_run(model, settled, settled_new),
                    bf16_settled_ngram=spec_run(model, settled, settled_new,
                                                spec_ngram=SPEC_NGRAM, **spec))
    profiled = {name: spec_run(model, prompts[:2], [16, 16], profiled=True, **kw, **spec)
                for name, kw in (("bf16_ngram", dict(spec_ngram=SPEC_NGRAM)),
                                 ("bf16_layers", dict(spec_layers=SPEC_LAYERS)))}
    # f32 weights and f32 compute (the preset computes in bf16).
    f32 = load_model({**CLI_MODEL, "config": {**CLI_MODEL["config"], "dtype": "float32"},
                      "serve_dtype": "float32"})
    fp, fn = prompts[:SPEC_F32_REQUESTS], [SPEC_F32_NEW] * SPEC_F32_REQUESTS
    runs.update(f32_off=spec_run(f32, fp, fn),
                f32_ngram=spec_run(f32, fp, fn, spec_ngram=SPEC_NGRAM, **spec),
                f32_fixed=spec_run(f32, fp, fn, block_size=0, ragged=False, prefill_chunk=0))
    off32 = runs["f32_off"]["answers"]
    spec_split = first_divergence(f32, fp, runs["f32_ngram"]["answers"], off32)
    fixed_split = first_divergence(f32, fp, runs["f32_fixed"]["answers"], off32)
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    problems = [] if settled else ["(c) no spec-off answer settled into a short cycle"]
    off = runs["bf16_off"]
    if spec_split is not None:  # (a)
        problems.append(f"(a) f32: spec_ngram changed the tokens: {spec_split}")
    agree = {}
    for name, run in runs.items():
        want, base = ((settled_new, runs["bf16_settled_off"]) if "settled" in name else
                      (n_new, off) if name.startswith("bf16") else (fn, None))
        if [len(a) for a in run["answers"]] != want:  # (b)
            problems.append(f"(b) {name}: answered {[len(a) for a in run['answers']]} tokens")
        if base is not None and run is not base:
            same = sum(a == b for x, y in zip(run["answers"], base["answers"])
                       for a, b in zip(x, y))
            agree[name] = same / sum(want)
    ng = runs["bf16_ngram"]
    none = dict(spec_accepted=0, spec_proposed=0, dispatches_per_token=0.0, tok_s=0.0)
    set_off, set_ng = runs.get("bf16_settled_off", none), runs.get("bf16_settled_ngram", none)
    if (not ng["spec_accepted"] > 0 or not set_ng["spec_accepted"] > 0  # (c)
            or not set_ng["dispatches_per_token"] < set_off["dispatches_per_token"]):
        problems.append(f"(c) spec_ngram accepted {ng['spec_accepted']} of "
                        f"{ng['spec_proposed']} (echo) and {set_ng['spec_accepted']} of "
                        f"{set_ng['spec_proposed']} (settled); on the settled traffic "
                        f"{set_ng['dispatches_per_token']:.4f} forwards an emitted token "
                        f"against {set_off['dispatches_per_token']:.4f} with spec off")
    if any(runs[name]["launches_by_route"][r] for name in ("f32_off", "f32_ngram")
           for r in ("decode", "mma")):
        problems.append("(a) an f32 run left the simt route: "
                        f"{[runs[n]['launches_by_route'] for n in ('f32_off', 'f32_ngram')]}")
    for name, run in profiled.items():  # (d)
        k = run["kernels"]
        if (run["spec_chunks"] <= 0 or k["ragged_mma_kernel"]["launches"] <= 0
                or k["ragged_kernel"]["launches"] or run["launches_by_route"]["simt"]
                or runs[name]["launches_by_route"]["simt"]):
            problems.append(f"(d) {name}: {run['spec_chunks']} verifies, kernels {k}")
    layers = profiled["bf16_layers"]
    if (not layers["draft_launches_by_route"]["decode"]
            or layers["kernels"]["ragged_decode_kernel"]["launches"] <= 0):
        problems.append(f"(d) the self-draft's launches {layers['draft_launches_by_route']}")
    if fixed_split is not None:  # (e)
        problems.append(f"(e) f32: the fixed-slot pool parts from the paged pool: {fixed_split}")
    for name, run in [*runs.items(), *(("profiled_" + k, v) for k, v in profiled.items())]:
        paged = not name.endswith("fixed")  # (f)
        if run["plain_attention_calls"] or (paged and run["dense_attention_calls"]):
            problems.append(f"(f) {name}: plain {run['plain_attention_calls']}, dense "
                            f"{run['dense_attention_calls']}")
    keep = ("wall_s", "tok_s", "decode_tok_s", "launches_by_route", "draft_launches_by_route",
            "dense_attention_calls", "prefill_chunks", "decode_chunks", "spec_chunks",
            "forwards", "dispatches_per_token", "forwards_per_token", "emitted",
            "spec_proposed", "spec_accepted", "spec_lanes", "lanes_proposing", "accept_rate",
            "verify_chunk_ms", "preemptions")
    res = dict(layers=model.config.num_layers, requests=len(prompts),
               prompt_lengths=[len(q) for q in prompts], n_new=n_new,
               settled_found=n_settled, settled_prompt_lengths=[len(q) for q in settled],
               settled_new=settled_new,
               # spec_ngram over spec off on each traffic (above 1: more).
               spec_over_off={name: {k: a[k] / b[k] if b[k] else None
                                     for k in ("tok_s", "dispatches_per_token")}
                              for name, a, b in (("echo", ng, off),
                                                 ("settled", set_ng, set_off))},
               f32_requests=SPEC_F32_REQUESTS, f32_new=SPEC_F32_NEW, pool=dict(SPEC_POOL),
               spec_ngram=SPEC_NGRAM, spec_layers=SPEC_LAYERS, spec_draft=SPEC_DRAFT,
               seed_run={k: seeded[k] for k in keep}, agreement_with_off=agree,
               f32_spec_identical=spec_split is None, f32_fixed_divergence=fixed_split,
               fixed_vs_paged_tok_s={"bf16": runs["bf16_fixed"]["tok_s"] / off["tok_s"],
                                     "f32": runs["f32_fixed"]["tok_s"] / runs["f32_off"]["tok_s"]},
               runs={name: {k: r[k] for k in keep} for name, r in runs.items()},
               profiled={name: {"kernels": r["kernels"], "spec_chunks": r["spec_chunks"],
                                "launches_by_route": r["launches_by_route"],
                                "draft_launches_by_route": r["draft_launches_by_route"]}
                         for name, r in profiled.items()},
               seconds=time.perf_counter() - t0)
    if problems:
        emit({"phase": "serve_spec", **res, "problems": problems})
        raise SystemExit("serve_spec: " + "; ".join(problems))
    return res


# ------------------------------------------------ tracing three phases

# serve_router, train_data (b) and train_het run traced (``traced_phase``):
# the smoke process's spans (its in-process scheduler and servers) through
# ``trace.enable``, the trainer processes' through the trace directory their
# executor hands them, the CLI processes' through ``HYPHA_TRACE_DIR`` and
# ``HYPHA_TRACE_NODE``; the flight ring spills into the same directory. Each
# phase prints its merged timeline (``render_text``) and holds the spans to
# its own gates; no later phase runs traced.
SPAN_COST_N = 10_000  # spans timed for the cost of one begin + finish
SPAN_COST_BUDGET = 0.03  # the reference's tracing budget, a share of the round


@contextmanager
def traced_phase(name: str):
    """Tracing on for one phase, under a fresh directory (yielded); off
    again, the flight ring spilled there and disarmed, when it ends."""
    from hypha_tpu_torch.telemetry import trace
    from hypha_tpu_torch.telemetry.flight import FLIGHT

    d = Path(tempfile.mkdtemp(prefix=f"htr-{name}-"))
    FLIGHT.clear()
    trace.enable(d, node="smoke")
    FLIGHT.configure(node="smoke", spill_dir=d)
    try:
        yield d
    finally:
        FLIGHT.spill()
        FLIGHT.disarm()
        trace.disable()


def span_cost_us(n: int = SPAN_COST_N) -> float:
    """Microseconds per traced ``begin`` + ``finish`` (one file line each,
    flushed), over ``n`` spans into a scratch directory."""
    from hypha_tpu_torch.telemetry import trace

    d = Path(tempfile.mkdtemp(prefix="htr-cost-"))
    try:
        trace.enable(d, node="cost")
        parent = "ab" * 16 + "-" + "cd" * 8
        t0 = time.perf_counter()
        for i in range(n):
            trace.finish(trace.begin("upload", parent=parent,
                                     attrs={"round": i, "peer": "w1", "bytes": 1 << 28}))
        seconds = time.perf_counter() - t0
    finally:
        trace.disable()
        shutil.rmtree(d, ignore_errors=True)
    return seconds / n * 1e6


def trace_summary(d: Path, phase: str) -> dict:
    """The merged timeline of a traced phase's directory, printed as text
    (each line prefixed with the phase), and its counts: spans, events,
    the files' bytes, the clock offsets."""
    from hypha_tpu_torch.telemetry import timeline

    tl = timeline.build_timeline(d)
    for line in timeline.render_text(tl).splitlines():
        print(f"[{phase} timeline] {line}", flush=True)
    files = sorted(p for p in d.iterdir() if p.suffix == ".jsonl"
                   and p.name.startswith(("spans-", "events-")))
    return dict(spans=tl["num_spans"], events=tl["num_events"],
                files={p.name: p.stat().st_size for p in files},
                bytes=sum(p.stat().st_size for p in files),
                clock_offsets_s=tl["clock_offsets_s"], timeline=tl)


def _dur_s(span: dict) -> float:
    return (span["mono_end_ns"] - span["mono_start_ns"]) / 1e9


# ------------------------------------------------ the metrics plane in two phases

# train_het and serve_router run with the live metrics plane on
# (``telemetry/metrics_plane.py``): every node reports its registry deltas to
# the scheduler's collector each METRICS_INTERVAL_S, the collector journals
# them (train_het: in the phase's trace directory; serve_router: in
# ``job.metrics_dir``) with the round quality and its SLO rules' breaches,
# and each phase holds the journal to its gates (``het_metrics_problems``,
# ``router_metrics_problems``). No phase is added for it.
METRICS_INTERVAL_S = 1.0
SAMPLE_COST_N = 2_000  # samples timed for the cost of one
# train_het's round wall rule: its steady rounds (over 20 s at 7B widths)
# breach 10 s once, edge-triggered, and never recover.
HET_ROUND_WALL_S = 10.0
# serve_router: a node silent this long breaches (w1, killed); p99 holds.
ROUTER_SILENT_S = 3.0
ROUTER_P99_MS = 120_000


def het_slo_rules(round_wall_s: float = HET_ROUND_WALL_S) -> list:
    return ["hypha.het.quorum_drops == 0", f"round_wall_s <= {round_wall_s:g}"]


def router_slo_rules(silent_s: float = ROUTER_SILENT_S) -> list:
    return [f"silent_s <= {silent_s:g}",
            f"hypha.serve.request_latency_ms.p99 <= {ROUTER_P99_MS:g}"]


def sample_cost_us(n: int = SAMPLE_COST_N) -> float:
    """Microseconds per ``RegistrySampler.sample()`` over this process's
    bundles as they stand (a node's byte counters moving each time), as a
    reporter takes one a report."""
    import types

    from hypha_tpu_torch.telemetry.metrics_plane import RegistrySampler

    node = types.SimpleNamespace(bytes_in=0, bytes_out=0)
    sampler = RegistrySampler(node)
    t0 = time.perf_counter()
    for _ in range(n):
        node.bytes_out += 1500
        sampler.sample()
    return (time.perf_counter() - t0) / n * 1e6


def metrics_journal(d: Path) -> tuple:
    """The records of the ``metrics-*.jsonl`` journals in ``d``, and their
    bytes."""
    from hypha_tpu_torch.telemetry.timeline import load_jsonl

    files = sorted(Path(d).glob("metrics-*.jsonl"))
    return [r for f in files for r in load_jsonl(f)], sum(f.stat().st_size for f in files)


def plane_figures(recs: list, nbytes: int) -> dict:
    """A journal's counts: reports per node, each node's reports' wire
    bytes (``MetricsReport`` re-encoded) a report and a second, the
    quality points, and the SLO breaches and recoveries by rule and peer."""
    from hypha_tpu_torch import messages
    from hypha_tpu_torch.telemetry.metrics_plane import MetricsReport

    reports: dict = {}
    for r in recs:
        if r["type"] == "report":
            wire = len(messages.encode(MetricsReport(
                job_id="", peer=r["peer"], round=r["round"], seq=r["seq"],
                interval_s=r["interval_s"], counters=r["counters"], gauges=r["gauges"],
                summaries=r["summaries"])))
            reports.setdefault(r["peer"], []).append((r["t"], wire))
    per_node = {}
    for peer, rows in sorted(reports.items()):
        span = rows[-1][0] - rows[0][0]
        per_node[peer] = {"reports": len(rows),
                          "wire_bytes_mean": statistics.mean(b for _, b in rows),
                          "wire_bytes_per_s": sum(b for _, b in rows) / span if span > 0 else None}

    def edges(breached: bool) -> dict:
        return dict(collections.Counter(f"{r['rule']} [{r['peer'] or 'fleet'}]" for r in recs
                                        if r["type"] == "slo" and r["breached"] is breached))

    return dict(per_node=per_node, journal_bytes=nbytes,
                quality_points=sum(r["type"] == "quality" for r in recs),
                breaches=edges(True), recoveries=edges(False))


def het_metrics_problems(run: dict, rep: dict, recs: list, *, round_wall_s: float,
                         server: str = "psw") -> list:
    """train_het's metrics-plane gates, on the CPU as on the card: (i) the
    journal holds reports from the server and from every trainer's node;
    (ii) each round's assignment that ``het_report`` reads (rounds 1 on,
    every peer) stands whole in some report's
    ``hypha.het.assigned_steps.<peer>`` gauges from the server; (iii) each
    trainer's quality point in the journal equals the round METRICS it sent
    on ``Progress``; (iv) ``round_wall_s`` breaches exactly once and
    ``hypha.het.quorum_drops == 0`` never."""
    problems = []
    peers = run["workers"]
    reported = {r["peer"] for r in recs if r["type"] == "report"}
    if not {server, *peers} <= reported:
        problems.append(f"(i) reports from {sorted(reported)}, wanted {server} and {peers}")
    prefix = "hypha.het.assigned_steps."
    seen = [{k[len(prefix):]: int(v) for k, v in r["gauges"].items() if k.startswith(prefix)}
            for r in recs if r["type"] == "report" and r["peer"] == server]
    for row in rep["per_round"]:
        want = row["assigned"]
        if row["round"] >= 1 and (not want or want not in seen):
            problems.append(f"(ii) round {row['round']}'s assignment {want} in none of "
                            f"{server}'s {len(seen)} reports' gauges")
    quality = {(r["peer"], r["round"]): r for r in recs if r["type"] == "quality"}
    for peer, rnd, metrics in run["result"].metrics:
        got = quality.get((peer, rnd))
        want = {k: float(v) for k, v in metrics.items()}
        if got is None or {k: got.get(k) for k in want} != want:
            problems.append(f"(iii) {peer} round {rnd}: journal {got}, METRICS {want}")
    slo = [r for r in recs if r["type"] == "slo"]
    wall = f"round_wall_s <= {round_wall_s:g}"
    wall_edges = [r["breached"] for r in slo if r["rule"] == wall]
    drops = [r for r in slo if r["rule"] == "hypha.het.quorum_drops == 0"]
    if wall_edges != [True] or drops:
        problems.append(f"(iv) {wall} edges {wall_edges} (wanted one breach), quorum-drop "
                        f"records {drops}")
    return problems


def _backend_worker(recs: list) -> dict:
    """Backend name -> worker, from the reporters' ``<peer>:<backend>``
    labels."""
    return {label.split(":", 1)[1]: label.split(":", 1)[0]
            for label in {r["peer"] for r in recs if r["type"] == "report"} if ":" in label}


def router_metrics_problems(run: dict, recs: list, *, silent_s: float) -> list:
    """serve_router's metrics-plane gates, on the CPU as on the card: (i)
    ``silent_s`` breaches for ``w1`` (its reporter and its heartbeats'
    backend) and for no other peer, after the kill and before the phase
    ends; (ii) the p99 rule holds; (iii) each worker's last
    ``hypha.serve.request_latency_ms`` count in the journal equals the
    requests it answered (``w0``: all, from its last launches line; ``w1``:
    up to its last report, from its launches line before the kill, its last
    report sent after its last answer); (iv) ``telemetry.top --once`` lists
    both workers from the live scheduler's address, and every reporting peer
    from the journal directory."""
    problems = []
    m = run["metrics"]
    owner = _backend_worker(recs)
    silent = f"silent_s <= {silent_s:g} @peer"
    breaches = [r for r in recs if r["type"] == "slo" and r["rule"] == silent and r["breached"]]
    who = {r["peer"].split(":", 1)[0] if ":" in r["peer"] else owner.get(r["peer"], r["peer"])
           for r in breaches}
    if who != {"w1"} or not all(m["killed_at"] < r["t"] < m["ended_at"] for r in breaches):
        problems.append(f"(i) {silent} breached for {sorted(who)} at "
                        f"{[(r['peer'], r['t'] - m['killed_at']) for r in breaches]} s after the "
                        "kill; wanted w1 alone, after its kill")
    p99 = [r for r in recs if r["type"] == "slo" and r["rule"].startswith(
        "hypha.serve.request_latency_ms.p99")]
    if p99:
        problems.append(f"(ii) the p99 rule breached: {p99}")
    counts = {}
    for r in recs:
        s = (r.get("summaries") or {}).get("hypha.serve.request_latency_ms")
        if r["type"] == "report" and s and ":" in r["peer"]:
            counts[r["peer"].split(":", 1)[0]] = int(s["count"])
    answered = {}
    for role, report in (("w0", run["workers"]["w0"]), ("w1", run["w1_before_kill"])):
        lc, cache = report["launches"] or {}, report["cache"] or {}
        answered[role] = lc.get("requests", 0) - cache.get("rejections", 0) - lc.get("fallbacks", 0)
    if counts != answered:
        problems.append(f"(iii) request latency counts {counts}, answered {answered}")
    live = set(m["top_live"].get("last_seen") or {})
    if not {"w0", "w1"} <= {owner.get(p, p.split(":", 1)[0]) for p in live}:
        problems.append(f"(iv) top at the live address listed {sorted(live)}")
    reporting = {r["peer"] for r in recs if r["type"] == "report"}
    if not reporting or not reporting <= set(m["top_dir"].get("last_seen") or {}):
        problems.append(f"(iv) top on the journal listed {sorted(m['top_dir'].get('last_seen') or {})}"
                        f", the journal's reporters {sorted(reporting)}")
    return problems


async def top_once(target: str) -> dict:
    """``python -m hypha_tpu_torch.telemetry.top <target> --once --json`` as
    a process of its own; its snapshot."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH", "")) if p)}
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "hypha_tpu_torch.telemetry.top", target, "--once", "--json",
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=repo)
    out, err = await asyncio.wait_for(proc.communicate(), 60)
    if proc.returncode != 0:
        raise SystemExit(f"telemetry.top {target} exited {proc.returncode}: "
                         f"{err.decode(errors='replace')[-2000:]}")
    return json.loads(out)


def het_trace_problems(d: Path, run: dict, *, rounds: int, rate_mbps: float,
                       capped: str = "w1") -> tuple:
    """train_het's trace gates, on the CPU as on the card: (i) one ``round``
    root a round; every trainer that sent the round a delta has its
    ``inner_steps``, ``encode`` and ``upload`` in the round's trace, and
    the server its ``quorum_wait``, ``outer_step``, ``broadcast`` and one
    ``fold`` and one receiver ``upload`` (naming the sender) per delta;
    (ii) each round's ``outer_step`` span within 10% or 50 ms of the
    probe's ``outer_step_s``; (iii) ``capped``'s receiver uploads last at
    least 0.9 x their bytes over ``rate_mbps``; (iv) the events hold the
    chaos actions; (v) every process's wall clock within 1 s of the
    scheduler's (``wall_skew_s``: a span's wall stamp less its monotonic
    one, the same system-wide monotonic clock on one host), so the true
    offsets are 0, and the merger's ``clock_offsets_s`` are what
    ``round_lags_s`` says they must be: each node's offset is minus the
    least, over rounds, of the time from the round's opening to the node's
    first span of it (within 1 ms), and every round of a node begins within
    1 s of the end of its spans of the round before. So the offset the
    merger applies on one host is the previous round's close on that node
    (the server's broadcast, a trainer's broadcast and merge), in both
    packages, and nothing else. Returns (problems, figures)."""
    from hypha_tpu_torch.telemetry import timeline

    spans, events = timeline.load_dir(d)
    tl = timeline.build_timeline(d)
    problems = []
    roots = [s for s in spans if s["name"] == "round"]
    by_round = {s["attrs"].get("round"): s for s in roots}
    if sorted(by_round) != list(range(rounds)) or len(roots) != rounds:
        problems.append(f"(i) round roots {sorted(s['attrs'].get('round') for s in roots)}")
    rec = run["rec"]
    outer_probe = list(rec["outer_step_s"])
    capped_uploads = []
    for r in range(rounds):
        root = by_round.get(r)
        tid = root["trace_id"] if root else None
        mine = [s for s in spans if (s.get("attrs") or {}).get("round") == r
                and s["name"] != "round"]
        senders = sorted({dl["from"] for dl in rec["deltas"] if dl["round"] == r})
        for w in senders:
            for name in ("inner_steps", "encode", "upload"):
                got = [s for s in mine if s["node"] == w and s["name"] == name]
                if len(got) != 1 or got[0]["trace_id"] != tid:
                    problems.append(f"(i) round {r}: {w}'s {name} spans "
                                    f"{[(s['trace_id'] == tid) for s in got]}")
        server = [s for s in mine if s["node"] == "psw"]
        for name in ("quorum_wait", "outer_step"):
            got = [s for s in server if s["name"] == name]
            if len(got) != 1 or got[0]["trace_id"] != tid:
                problems.append(f"(i) round {r}: the server's {name} spans {len(got)}")
        bcast = [s for s in server if s["name"] == "broadcast"]
        if not bcast or any(s["trace_id"] != tid for s in bcast):
            problems.append(f"(i) round {r}: {len(bcast)} broadcast spans, not all in the trace")
        for name in ("fold", "upload"):
            got = [s for s in server if s["name"] == name]
            peers = sorted(s["attrs"].get("peer") for s in got)
            if peers != senders or any(s["trace_id"] != tid for s in got):
                problems.append(f"(i) round {r}: the server's {name} spans name {peers}, "
                                f"deltas came from {senders}")
        outer = [_dur_s(s) for s in server if s["name"] == "outer_step"]
        if outer and r < len(outer_probe):
            if abs(outer[0] - outer_probe[r]) > max(0.1 * outer_probe[r], 0.05):
                problems.append(f"(ii) round {r}: outer_step span {outer[0]:.3f} s, probe "
                                f"{outer_probe[r]:.3f} s")
        for s in server:
            if s["name"] == "upload" and s["attrs"].get("peer") == capped:
                floor = 0.9 * s["attrs"].get("bytes", 0) * 8 / (rate_mbps * 1e6)
                capped_uploads.append({"round": r, "s": _dur_s(s), "bytes": s["attrs"].get("bytes"),
                                       "floor_s": floor})
                if _dur_s(s) < floor:
                    problems.append(f"(iii) round {r}: {capped}'s upload took {_dur_s(s):.3f} s "
                                    f"for {s['attrs'].get('bytes')} bytes (floor {floor:.3f} s)")
    if len(outer_probe) != rounds:
        problems.append(f"(ii) {len(outer_probe)} probed outer steps for {rounds} rounds")
    if not capped_uploads:
        problems.append(f"(iii) no receiver upload span names {capped}")
    fired = sorted((e["event"], e["node"]) for e in events if e["event"].startswith("chaos."))
    want = sorted((f"chaos.{kind}", target) for kind, target, _ in run["chaos"])
    if fired != want:
        problems.append(f"(iv) chaos events {fired}, wanted {want}")
    skew = wall_skew_s(spans)
    far = {n: o for n, o in skew.items() if abs(o) >= 1.0}
    if far or "scheduler" not in skew:
        problems.append(f"(v) wall clocks off the scheduler's: {skew}")
    lags = round_lags_s(spans)
    offsets = tl["clock_offsets_s"]
    if set(offsets) != set(lags) | {"scheduler"}:
        problems.append(f"(v) the merger's offsets name {sorted(offsets)}, the spans "
                        f"{sorted(lags)}")
    for node, row in sorted(lags.items()):
        if abs(offsets.get(node, 0.0) + row["lag_s"]) >= 1e-3:
            problems.append(f"(v) {node}: the merger's offset {offsets.get(node)} s, its least "
                            f"round-open lag {row['lag_s']:.6f} s")
        late = {r: g for r, g in row["gaps_s"].items() if g >= 1.0}
        if late:
            problems.append(f"(v) {node}: rounds begin {late} s after its spans of the round "
                            f"before end")
    steady = [{k: row[k] for k in ("round", "wall_s", "straggler", "stall_span", "stall_peer",
                                   "stall_s", "dominant", "dominant_peer", "upload_s_max",
                                   "upload_s_second")}
              for row in tl["rounds"] if row["round"] >= 1]
    return problems, dict(capped_uploads=capped_uploads, chaos_events=fired, steady=steady,
                          wall_skew_s=skew, clock_offsets_s=tl["clock_offsets_s"],
                          round_lags_s=lags,
                          spans_per_round=len([s for s in spans if "round" in (s.get("attrs") or {})])
                          / max(rounds, 1))


def round_lags_s(spans: list, ref: str = "scheduler") -> dict:
    """For each node but ``ref``: ``lag_s``, the least over rounds of its
    first span of a round less the start of ``ref``'s root span of that
    round (what the merger anchors on), ``round``, the round that gives
    it, and ``gaps_s``, for each round after the first, the node's first
    span of it less the end of its last span of the round before, all on
    the wall clock."""
    opened = {s["attrs"]["round"]: s["start_ns"] for s in spans
              if s["node"] == ref and s["name"] == "round"}
    per: dict = {}
    for s in spans:
        r = (s.get("attrs") or {}).get("round")
        if s["node"] != ref and r in opened:
            first, last = per.setdefault(s["node"], {}).get(r, (None, None))
            end = s["end_ns"] if isinstance(s.get("end_ns"), int) else s["start_ns"]
            per[s["node"]][r] = (s["start_ns"] if first is None else min(first, s["start_ns"]),
                                 end if last is None else max(last, end))
    out = {}
    for node, rounds in per.items():
        r0 = min(rounds, key=lambda r: rounds[r][0] - opened[r])
        out[node] = dict(lag_s=(rounds[r0][0] - opened[r0]) / 1e9, round=r0,
                         gaps_s={r: (rounds[r][0] - rounds[r - 1][1]) / 1e9
                                 for r in sorted(rounds) if r - 1 in rounds})
    return out


def wall_skew_s(spans: list, ref: str = "scheduler") -> dict:
    """Each node's wall clock less ``ref``'s, in seconds: the median of its
    spans' wall stamp less their monotonic one (one host's monotonic clock
    is the same in every process), relative to ``ref``'s."""
    per: dict = {}
    for s in spans:
        per.setdefault(s["node"], []).append(s["start_ns"] - s["mono_start_ns"])
    base = statistics.median(per[ref]) if ref in per else None
    return {n: (statistics.median(v) - base) / 1e9 for n, v in sorted(per.items())
            if base is not None}


def data_trace_problems(d: Path, rep: dict) -> tuple:
    """train_data (b)'s trace gates: each trainer's ``input_wait`` spans as
    many as the boundary waits of its ``data metrics`` line (the span wraps
    exactly that wait), each in a round's trace but those that began before
    the trainer's first ``encode`` (the job's first slices, fetched before
    the scheduler handed down a round); and the longest wait."""
    from hypha_tpu_torch.telemetry import timeline

    spans, _ = timeline.load_dir(d)
    rounds = {s["trace_id"] for s in spans if s["name"] == "round"}
    problems, longest = [], {}
    for peer, t in rep["trainers"].items():
        waits = [s for s in spans if s["name"] == "input_wait" and s["node"] == peer]
        want = (t["data_metrics"] or {}).get("boundary_waits")
        if len(waits) != want:
            problems.append(f"{peer}: {len(waits)} input_wait spans, {want} boundary waits")
        encodes = [s["start_ns"] for s in spans if s["name"] == "encode" and s["node"] == peer]
        first = min(encodes, default=None)
        stray = [s for s in waits if s["trace_id"] not in rounds
                 and (first is None or s["start_ns"] >= first)]
        if stray or first is None:
            problems.append(f"{peer}: {len(stray)} input_wait spans outside a round's trace "
                            f"after its first encode")
        if waits:
            w = max(waits, key=_dur_s)
            longest[peer] = {"s": _dur_s(w), "in_round_trace": w["trace_id"] in rounds,
                             "before_first_encode": first is not None and w["start_ns"] < first}
        longest[peer] = {**longest.get(peer, {}), "count": len(waits),
                         "outside_round_trace": sum(s["trace_id"] not in rounds for s in waits)}
    return problems, longest


class OtlpCollector:
    """A loopback OTLP/HTTP collector (``http.server`` on 127.0.0.1 in a
    thread of this process): stores each POST's path and JSON."""

    def __init__(self) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        posts = self.posts = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("content-length", 0)))
                posts.append((self.path, json.loads(body)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.endpoint = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)

    def services(self, path: str) -> dict:
        """service.name -> the payloads posted to ``path`` by it."""
        out: dict = {}
        for p, payload in self.posts:
            if p != path:
                continue
            for res in next(iter(payload.values())):
                attrs = {a["key"]: next(iter(a["value"].values()))
                         for a in res["resource"]["attributes"]}
                out.setdefault(attrs.get("service.name"), []).append(res)
        return out


def router_trace_problems(d: Path, collector: OtlpCollector, *, answered: int,
                          alive: tuple) -> tuple:
    """serve_router's trace gates: (i) each answered request has a
    ``route`` span on the scheduler whose trace holds a ``prefill`` span on
    the worker that answered (the route's ``backend``); (ii) the killed
    ``w1``'s spans read through its kill (a torn tail ends the file as a
    clean EOF); (iii) the collector got the scheduler's ``serve_job`` span
    on ``/v1/traces`` and ``hypha.bandwidth.inbound.bytes`` on
    ``/v1/metrics`` from every node in ``alive``."""
    from hypha_tpu_torch.telemetry import timeline

    spans, _ = timeline.load_dir(d)
    problems = []
    routes = [s for s in spans if s["name"] == "route" and s["node"] == "scheduler"]
    by_trace: dict = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    served = [r for r in routes
              if any(s["name"] == "prefill" and s["node"] == r["attrs"].get("backend")
                     for s in by_trace[r["trace_id"]])]
    if len(served) != answered:
        problems.append(f"(i) {len(served)} route spans with the answering worker's prefill in "
                        f"their trace ({len(routes)} routes), {answered} answers")
    w1_path = d / "spans-w1.jsonl"
    w1_lines = w1_path.read_text().splitlines() if w1_path.exists() else []
    w1 = timeline.load_jsonl(w1_path)
    if not w1:
        problems.append("(ii) no span of w1 read")
    torn = bool(w1_lines) and len(w1) < len([x for x in w1_lines if x.strip()])
    traces = collector.services("/v1/traces")
    sched_spans = [s["name"] for res in traces.get("hypha-scheduler", [])
                   for ss in res["scopeSpans"] for s in ss["spans"]]
    if "serve_job" not in sched_spans:
        problems.append(f"(iii) the scheduler exported {sched_spans}, no serve_job")
    metrics = collector.services("/v1/metrics")
    gauges = {svc: {m["name"] for res in payloads for sm in res["scopeMetrics"]
                    for m in sm["metrics"]} for svc, payloads in metrics.items()}
    for node in alive:
        if "hypha.bandwidth.inbound.bytes" not in gauges.get(f"hypha-{node}", set()):
            problems.append(f"(iii) no hypha.bandwidth.inbound.bytes from {node}: {gauges}")
    return problems, dict(routes=len(routes), answered_routes=len(served), w1_spans=len(w1),
                          w1_torn_tail=torn, posts=collections.Counter(p for p, _ in
                                                                       collector.posts),
                          services=sorted(gauges))


# ------------------------------------------------ serve_router phase

# ``SERVE_JOB`` spread over two workers behind the scheduler's router.
ROUTER_JOB = {**SERVE_JOB, "job.serve_workers": 2, "job.serve_prefix_cache": True,
              "job.serve_prefix_affinity": True, "job.serve_queue_limit": 4}
ROUTER_WORKERS = {"w0": "w0", "w1": "w1"}
ROUTER_ROLES = ("gateway", "w0", "w1", "scheduler")
LOAD_REPORT_S = 1.0  # the supervisor's heartbeat period (its default)


async def _device_mem_sampler(peak: list, stop: asyncio.Event) -> None:
    """The card's used memory, all processes together, every 0.5 s."""
    while not stop.is_set():
        proc = await asyncio.create_subprocess_exec(
            "nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits",
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        out, _ = await proc.communicate()
        try:
            peak[0] = max(peak[0], float(out.decode().split()[0]))
        except (ValueError, IndexError):
            pass
        try:
            await asyncio.wait_for(stop.wait(), 0.5)
        except asyncio.TimeoutError:
            pass


async def run_serve_router(root: Path, job: dict, prompts: list, n_new: list, *,
                           device: "str | None" = None, repeat: int = 4,
                           trace_dir: "Path | None" = None, otlp: "str | None" = None,
                           slo_rules: "list | None" = None,
                           metrics_interval_s: float = METRICS_INTERVAL_S) -> dict:
    """``ServeNet`` with two workers, ``w0`` and ``w1``, behind the
    scheduler's router (``job`` routes). Once both backends serve, the
    client sends every prompt at once through ``generate_remote``, then the
    first ``repeat`` again; then it SIGKILLs ``w1``, sends the last
    ``repeat`` prompts again, which ``w0`` must answer, and waits for the
    scheduler to fail ``w1``'s slot (by φ ejection or by a failed lease
    renewal); then every process left stops. Every wait has a deadline.
    ``trace_dir`` and ``otlp`` go to ``ServeNet``. With ``slo_rules`` (a
    list) the deployment runs the live metrics plane, journaling under
    ``root/metrics``: two report periods after the repeats (so ``w1``'s last
    report covers its answers) ``telemetry.top --once`` reads the live
    scheduler, and after the processes stop, the journal directory."""
    from hypha_tpu_torch.messages import PROTOCOL_GENERATE

    name = job["job.serve_name"]
    metrics_dir = root / "metrics" if slo_rules is not None else None
    if metrics_dir is not None:
        job = {**job, "job.metrics_plane": True, "job.metrics_interval_s": metrics_interval_s,
               "job.metrics_dir": str(metrics_dir), "job.slo_rules": list(slo_rules)}
    plane: dict = {}
    net = ServeNet(root, job, ROUTER_WORKERS, device, trace_dir=trace_dir, otlp=otlp)
    net.init()
    loop = asyncio.get_running_loop()
    mem_peak, sampling = [0.0], asyncio.Event()
    sampler = (asyncio.create_task(_device_mem_sampler(mem_peak, sampling))
               if device is None else None)
    busy = [0, 0.0]  # retry-after answers, and the seconds they asked to wait
    t0, started_at = time.perf_counter(), time.time()
    try:
        await net.start()
        ask = net.client.request

        async def counted(peer, proto, msg, **kw):
            resp = await ask(peer, proto, msg, **kw)
            if proto == PROTOCOL_GENERATE and not getattr(resp, "ok", True):
                # A retry-after answer: generate_remote sleeps the hint and
                # asks again.
                busy[0] += 1
                busy[1] += resp.retry_after_ms / 1e3
            return resp

        net.client.request = counted
        await net.wait_for_provider(name)
        deadline = loop.time() + NODE_WAIT_S
        for role in ROUTER_WORKERS:
            await _wait_for_text(net.logs[role], f"serving {name}@", net.procs[role], deadline)
        # The router routes to a backend once its first heartbeat lands,
        # one heartbeat period after the backend serves.
        await asyncio.sleep(2 * LOAD_REPORT_S)
        bring_up_s = time.perf_counter() - t0
        sampling.set()
        t1 = time.perf_counter()
        got = await asyncio.wait_for(asyncio.gather(*(
            _timed_ask(net.client, name, p, n) for p, n in zip(prompts, n_new))), NODE_WAIT_S)
        wall_s = time.perf_counter() - t1
        again = await asyncio.wait_for(asyncio.gather(*(
            _timed_ask(net.client, name, p, n)
            for p, n in zip(prompts[:repeat], n_new[:repeat]))), NODE_WAIT_S)
        if metrics_dir is not None:
            await asyncio.sleep(2 * metrics_interval_s)
            found = re.search(r"scheduler \S+ on \['([^']+)'", net.text("scheduler"))
            if found is None:
                raise SystemExit("the scheduler logged no listen address")
            plane["top_live"] = await top_once(found.group(1))
        before = {role: net.worker_report(role) for role in ROUTER_WORKERS}
        killed_at = time.time()
        await net.kill("w1")
        after = await asyncio.wait_for(asyncio.gather(*(
            _timed_ask(net.client, name, p, n)
            for p, n in zip(prompts[-repeat:], n_new[-repeat:]))), NODE_WAIT_S)
        await _wait_for_text(net.logs["scheduler"], "serving worker w1 failed",
                             net.procs["scheduler"], loop.time() + NODE_WAIT_S)
        if metrics_dir is not None:
            # w1 silent past the silence rule's threshold, the collector's
            # sweep (each second) and a report period: its breach is
            # journaled before the scheduler stops.
            from hypha_tpu_torch.telemetry.slo import parse_slo_rules

            silent = max((r.threshold for r in parse_slo_rules(slo_rules)
                          if r.metric == "silent_s"), default=0.0)
            await asyncio.sleep(max(killed_at + silent + metrics_interval_s + 2.0 - time.time(),
                                    0.0))
        ended_at = time.time()
    finally:
        sampling.set()
        if sampler is not None:
            await sampler
        await net.stop()
    if metrics_dir is not None:
        plane.update(top_dir=await top_once(str(metrics_dir)), killed_at=killed_at,
                     ended_at=ended_at)
        plane["records"], plane["journal_bytes"] = metrics_journal(metrics_dir)
    sched = net.text("scheduler").splitlines()
    dispatched = [_log_time(line) for line in sched if f"serving {name} slot " in line
                  and " deployed on " in line]
    failed = [line for line in sched if "serving worker w1 failed" in line]
    ejected = [line for line in sched if "ejecting serving worker w1" in line]
    router = [json.loads(line.split(f"serving {name} router: ", 1)[1]) for line in sched
              if f"serving {name} router: " in line]
    reports = {"w0": net.worker_report("w0"), "w1": before["w1"]}
    # The bring-up's timeline, from the start of the phase: each slot
    # dispatched (scheduler) and each backend serving (its worker).
    timeline = {f"slot_{line.split(' slot ', 1)[1].split()[0]}_deployed_s":
                _log_time(line) - started_at for line in sched
                if f"serving {name} slot " in line and " deployed on " in line}
    for role in ROUTER_WORKERS:
        serving = [_log_time(line) - started_at for line in net.text(role).splitlines()
                   if f" serving {name}@" in line]
        timeline[f"{role}_serving_s"] = serving[0] if serving else None
    timeline["empty_auctions"] = sum(f"no offers for serving {name}" in line for line in sched)
    latencies = sorted(lat for _, lat, _ in got)
    return dict(
        answers=[t for t, _, _ in got], again=[t for t, _, _ in again],
        after_kill=[t for t, _, _ in after], bring_up_s=bring_up_s,
        dispatch_to_first_answer_s=(min(at for _, _, at in got) - min(dispatched)
                                    if dispatched else None),
        latency_s=[lat for _, lat, _ in got], latency_median_s=statistics.median(latencies),
        latency_max_s=latencies[-1], wall_s=wall_s,
        after_kill_latency_s=[lat for _, lat, _ in after], busy_answers=busy[0],
        busy_wait_s=busy[1],
        router=router[-1] if router else None,
        slot_failed_s=(_log_time(failed[0]) - killed_at) if failed else None,
        slot_failed_by=("phi-accrual ejection" if ejected else "lease") if failed else None,
        slot_failed_line=failed[0][24:] if failed else None,
        w0_requests_after_kill=(reports["w0"]["launches"]["requests"]
                                - before["w0"]["launches"]["requests"]
                                if reports["w0"]["launches"] and before["w0"]["launches"]
                                else None),
        workers=reports, timeline=timeline, bring_up_device_mem_mib=mem_peak[0] if sampler else None,
        w1_before_kill=before["w1"], metrics=plane,
        exits=net.exits, stop_s=net.stop_s, leftover=net.leftover(skip=("w1",)),
        logs={role: str(path) for role, path in net.logs.items()},
    )


def serve_router_problems(run: dict, *, want: list, n_new: list, layers: int,
                          device: str, repeat: int = 4) -> list:
    """The gates of the serve_router phase: every answer (the burst, the
    repeats, the answers after the kill) equal to ``want``; each worker's
    launch gates (``launch_problems``) with requests above 0; prefix-cache
    hits across the backends; the scheduler's router counts logged;
    ``w1``'s slot failed after the kill and ``w0`` answered what came
    after; the scheduler, ``w0`` and the gateway out with 0 within
    ``STOP_WAIT_S``; nothing left in the work root but ``w1``'s."""
    problems = []
    wants = (("the burst", run["answers"], want), ("the repeats", run["again"], want[:repeat]),
             ("after the kill", run["after_kill"], want[-repeat:]))
    for what, got, ref in wants:
        if [t[0] if len(t) == 1 else t for t in got] != ref:
            problems.append(f"{what}: answers differ from the in-process pool's")
    for role, report in run["workers"].items():
        problems += launch_problems(role, report["launches"], report["kernel_builds"],
                                    layers=layers, device=device)
        if not report["launches"] or report["launches"]["requests"] <= 0:
            problems.append(f"{role} served no request")
    hits = sum((r["cache"] or {}).get("hit_blocks", 0) for r in run["workers"].values())
    if hits <= 0:
        problems.append("no prefix-cache hit on either backend")
    if not run["router"] or not {"routed", "rejected"} <= set(run["router"]):
        problems.append(f"the scheduler logged no router counts: {run['router']}")
    if run["slot_failed_by"] is None:
        problems.append("w1's slot never failed after the kill")
    if not run["w0_requests_after_kill"] or run["w0_requests_after_kill"] < repeat:
        problems.append(f"w0 took {run['w0_requests_after_kill']} requests after the kill")
    problems += exit_problems(run, ("scheduler", "w0", "gateway"))
    if run["leftover"]:
        problems.append(f"left in the work root: {run['leftover']}")
    return problems


def serve_router_phase(prefix: dict) -> dict:
    """``serve_prefix``'s requests through the scheduler's router over two
    workers, each a process of its own started from TOML by the port's
    CLI, then ``w1`` killed; traced, every process exporting to a loopback
    OTLP collector (``router_trace_problems``), and with the live metrics
    plane on (``router_metrics_problems``)."""
    root = Path(tempfile.mkdtemp(prefix="hsr"))
    collector = OtlpCollector()
    tdir = None
    rules = router_slo_rules()
    try:
        with traced_phase("serve_router") as tdir:
            run = asyncio.run(run_serve_router(root, ROUTER_JOB, prefix["prompts"],
                                               prefix["n_new"], trace_dir=tdir,
                                               otlp=collector.endpoint, slo_rules=rules))
        problems = serve_router_problems(run, want=prefix["answers"], n_new=prefix["n_new"],
                                         layers=prefix["layers"], device="cuda")
        m = run["metrics"]
        problems += [f"metrics {x}" for x in router_metrics_problems(
            run, m["records"], silent_s=ROUTER_SILENT_S)]
        plane = {**plane_figures(m["records"], m["journal_bytes"]), "rules": rules,
                 "interval_s": METRICS_INTERVAL_S,
                 "top_live_peers": sorted(m["top_live"].get("last_seen") or {}),
                 "top_dir_peers": sorted(m["top_dir"].get("last_seen") or {})}
        print(f"[serve_router metrics] {json.dumps(plane)}", flush=True)
        answered = len(run["answers"]) + len(run["again"]) + len(run["after_kill"])
        tproblems, tfig = router_trace_problems(tdir, collector, answered=answered,
                                                alive=ROUTER_ROLES)
        problems += tproblems
        tsum = trace_summary(tdir, "serve_router")
        if problems:
            logs = {r: Path(p).read_text(errors="replace")[-3000:] for r, p in run["logs"].items()}
            raise SystemExit(f"serve_router: {problems}\n{json.dumps(logs, indent=1)}")
    finally:
        collector.close()
        shutil.rmtree(root, ignore_errors=True)
        if tdir is not None:
            shutil.rmtree(tdir, ignore_errors=True)
    keep = ("bring_up_s", "dispatch_to_first_answer_s", "latency_s", "latency_median_s",
            "latency_max_s", "wall_s", "after_kill_latency_s", "busy_answers", "busy_wait_s",
            "router",
            "slot_failed_s", "slot_failed_by", "slot_failed_line", "w0_requests_after_kill",
            "workers", "timeline", "bring_up_device_mem_mib", "stop_s", "exits")
    return dict(requests=len(prefix["prompts"]), answers_equal_serve_prefix=True,
                **{k: run[k] for k in keep},
                trace={**tfig, **{k: v for k, v in tsum.items() if k != "timeline"}},
                metrics_plane=plane)


# ------------------------------------------------ serve_fleet phase

# ``SERVE_JOB`` over two workers with the fleet prefix cache and KV migration on.
# Prefill chunks of 32, so a prompt past a pulled 2-block prefix prefills in
# fewer forwards than cold; 40 blocks a pool: serve_prefix's longest request
# needs 36 (the pool's window bound at chunk 32).
FLEET_BLOCKS = 40
FLEET_CHUNK = 32
FLEET_JOB = {**SERVE_JOB, "job.serve_workers": 2, "job.serve_prefix_cache": True,
             "job.serve_fleet_cache": True, "job.serve_kv_migration": True,
             "job.serve_digest_k": 32, "job.serve_prefill_chunk": FLEET_CHUNK,
             "job.serve_blocks": FLEET_BLOCKS}
FLEET_SEED = 21
# The dry-pool requests (prompt tokens, new tokens), sent straight to one
# backend in this order: a blocker that holds the pool (34 of its 40 blocks)
# while the others queue, so they are admitted together when it ends and the
# schedule is the pool's own, the same in process; 4 hogs whose growth dries
# the pool; V, whose 9 full blocks at preemption pass the frame cap; S,
# whose 3 fit. A CPU dry run of this pool (the tiny model, the same
# geometry, stepped by hand) preempts S first, then V, and no hog.
MIGRATE_REQUESTS = [(544, 64)] + [(80, 48)] * 4 + [(128, 32), (24, 39)]
ORDER_GAP_S = 0.005  # between two of them, so they arrive in this order


def fleet_traffic(seed: int = FLEET_SEED, vocab: int = 32_000) -> dict:
    """The phase's own requests. ``family``: a warm-up and 6 more prompts
    sharing a 32-token (2-block) prefix, each prompt plus budget under 64
    tokens, so every chain of theirs fits one frame. ``migrate``:
    ``MIGRATE_REQUESTS``' prompts drawn from the seed."""
    fam = make_prompts(seed, [32], vocab)[0]
    tails = make_prompts(seed + 1, [8, 9, 10, 11, 12, 13, 14], vocab)
    prompts = make_prompts(seed + 2, [p for p, _ in MIGRATE_REQUESTS], vocab)
    return {"family": [(fam + t, min(63 - 32 - len(t), 20)) for t in tails],
            "migrate": [(p, n) for p, (_, n) in zip(prompts, MIGRATE_REQUESTS)]}


def migration_reference(model, requests: list) -> dict:
    """``requests`` queued at once in a pool of ``FLEET_JOB``'s geometry,
    stepped by hand, with the worker's migration path in process: each
    ticket the pool cuts is framed as the worker frames its
    ``MigrateRequest``; past ``MAX_FRAME`` it goes back to the pool
    (requeue), else a second pool lands its blocks and decodes the rest.
    Returns the answers and each ticket's blocks, emitted tokens and fate."""
    from concurrent.futures import Future

    from hypha_tpu_torch import codec, messages
    from hypha_tpu_torch.executor.pool import DecodePool, _Group
    from hypha_tpu_torch.network.fabric import MAX_FRAME
    from hypha_tpu_torch.ops.kvcache import leaves_to_wire

    opts = dict(slots=8, max_len=1024, steps_per_call=8, block_size=16,
                num_blocks=FLEET_BLOCKS, prefill_chunk=FLEET_CHUNK, ragged=True,
                prefix_cache=True, fleet_cache=True, kv_migration=True)
    src, dst = DecodePool(model, **opts), DecodePool(model, **opts)
    tickets, events, groups = [], [], []
    src.set_migrate_hooks(lambda est, toks: ("dst", "dst"), tickets.append)
    for p, n in requests:
        g = _Group([list(p)], int(n), Future())
        with src._submit_lock:
            src._backlog += 1
        src._waiting.append(g)
        groups.append(g)
    try:
        with torch.inference_mode():
            while not all(g.fut.done() for g in groups):
                src._step_paged()
                while tickets:
                    t = tickets.pop(0)
                    req = messages.MigrateRequest(
                        serve_name="dst", prompt=t["prompt"], emitted=t["emitted"],
                        budget=t["budget"], chain_hashes=t["hashes"],
                        block_size=t["block_size"], leaves=leaves_to_wire(t["leaves"]))
                    frame = len(codec.dumps(messages.encode(req)))
                    events.append(dict(request=groups.index(t["group"]), blocks=len(t["hashes"]),
                                       emitted=len(t["emitted"]), frame_bytes=frame,
                                       shipped=frame <= MAX_FRAME))
                    if frame > MAX_FRAME:
                        src.requeue_migrated(t["group"])
                        while not src._queue.empty():  # as the serve loop takes it
                            src._waiting.append(src._queue.get_nowait())
                        continue
                    dst.inject_chain(t["hashes"], t["leaves"], None, None).result(timeout=300)
                    cont = dst.submit([t["prompt"] + t["emitted"]], t["budget"]).result(timeout=300)
                    src.complete_migrated(t["group"], cont[0])
        return {"answers": [g.fut.result(timeout=1)[0] for g in groups], "events": events}
    finally:
        src.close()
        dst.close()


def fleet_reference(model, traffic: dict) -> dict:
    """The in-process answers to ``traffic``: the family at once through
    one pool of ``FLEET_JOB``'s geometry, the dry-pool requests through
    ``migration_reference``."""
    fam = traffic["family"]
    ref = migration_reference(model, traffic["migrate"])
    return {"family": _pool_run(model, [p for p, _ in fam], [n for _, n in fam],
                                prefix_cache=True, num_blocks=FLEET_BLOCKS,
                                prefill_chunk=FLEET_CHUNK)["answers"],
            "migrate": ref["answers"], "migrate_events": ref["events"]}


_PULL_OK = re.compile(r"fleet pull from (\S+): (\d+) blocks, (\d+) bytes in ([\d.]+) s; "
                      r"(\d+) injected; link estimate ([\d.e+]+) bit/s")
_PULL_FAIL = re.compile(r"fleet pull from (\S+) failed after ([\d.]+) s \((\d+) blocks asked\): (.*)")
_MIGRATE_OK = re.compile(r"migration to (\S+): (\d+) blocks, (\d+) bytes, acked in ([\d.]+) s")
_MIGRATE_FAIL = re.compile(r"migration to (\S+) failed after ([\d.]+) s \((\d+) blocks, (\d+) "
                           r"bytes\): (.*)")


def fleet_log(text: str) -> dict:
    """A worker's block plane from its log: each pull and migration with its
    blocks, bytes and seconds, each failure with its error; a failure is
    at the frame cap when the sender's frame was too large (a migration)
    or the holder closed the stream unanswered (a pull: its reply frame)."""
    pulls = [dict(peer=m[1], blocks=int(m[2]), bytes=int(m[3]), rpc_s=float(m[4]),
                  injected=int(m[5]), link_bps=float(m[6]),
                  mb_per_s=int(m[3]) / 1e6 / max(float(m[4]), 1e-9))
             for m in _PULL_OK.finditer(text)]
    pull_failed = [dict(peer=m[1], s=float(m[2]), blocks_asked=int(m[3]), error=m[4],
                        frame_cap="EOF" in m[4] or "frame" in m[4])
                   for m in _PULL_FAIL.finditer(text)]
    migrations = [dict(peer=m[1], blocks=int(m[2]), bytes=int(m[3]), rpc_s=float(m[4]))
                  for m in _MIGRATE_OK.finditer(text)]
    migrate_failed = [dict(peer=m[1], s=float(m[2]), blocks=int(m[3]), bytes=int(m[4]),
                           error=m[5], frame_cap="frame too large" in m[5])
                      for m in _MIGRATE_FAIL.finditer(text)]
    return dict(pulls=pulls, pull_failed=pull_failed, migrations=migrations,
                migrate_failed=migrate_failed)


async def _ask_backend(client, peer: str, name: str, prompt: list, n: int) -> tuple:
    """One request straight to a backend (its ``<name>@<slot>``), past the
    router."""
    from hypha_tpu_torch.messages import PROTOCOL_GENERATE, GenerateRequest

    t = time.perf_counter()
    resp = await client.request(peer, PROTOCOL_GENERATE, GenerateRequest(
        serve_name=name, prompts=[prompt], max_new_tokens=n), timeout=NODE_WAIT_S)
    if not resp.ok:
        raise SystemExit(f"{name} answered ok=False: {resp}")
    return resp.tokens[0], time.perf_counter() - t


def _delta(after: dict, before: dict, key: str, field: str) -> int:
    return (after[key] or {}).get(field, 0) - (before[key] or {}).get(field, 0)


async def run_serve_fleet(root: Path, job: dict, traffic: dict, prefix_prompts: list,
                          prefix_new: list, *, device: "str | None" = None) -> dict:
    """``ServeNet`` with two workers behind the router, ``job`` with the
    fleet prefix cache and KV migration on. Once both backends serve and have
    heartbeated: (1) the dry-pool requests straight to backend 0, in order,
    ``ORDER_GAP_S`` apart; (2) through the router, the family's warm-up,
    then (after two heartbeats carry the digests) its 6 other prompts at
    once, so the router sends what the holder cannot take to the other
    backend with the holder to pull from; (3) ``prefix_prompts``: the first
    4 (one of each family) one by one straight to the backend that pulled
    in (2), the 8th (the last family's second) straight to the other one
    stamped with the first as ``pull_peer`` (its 20-block chain passes the
    frame; that backend has not measured the link, so it tries), then,
    after two heartbeats, the other 11 through the router. Then every
    process stops. Returns the answers, the workers' reports at each step,
    their block-plane logs (``fleet_log``), the router's counts, timings,
    the card's memory, exits and leftovers."""
    from hypha_tpu_torch.messages import PROTOCOL_GENERATE, GenerateRequest
    from hypha_tpu_torch.worker.infer_executor import serve_key

    name = job["job.serve_name"]
    net = ServeNet(root, job, ROUTER_WORKERS, device)
    net.init()
    loop = asyncio.get_running_loop()
    mem_peak, sampling = [0.0], asyncio.Event()
    sampler = (asyncio.create_task(_device_mem_sampler(mem_peak, sampling))
               if device is None else None)
    t0 = time.perf_counter()
    snaps = {}

    def snap(label):
        snaps[label] = {role: net.worker_report(role) for role in ROUTER_WORKERS}

    try:
        await net.start()
        await net.wait_for_provider(name)
        deadline = loop.time() + NODE_WAIT_S
        for role in ROUTER_WORKERS:
            await _wait_for_text(net.logs[role], f"serving {name}@", net.procs[role], deadline)
        await asyncio.sleep(2 * LOAD_REPORT_S)
        bring_up_s = time.perf_counter() - t0
        slot_of = {role: int(re.search(rf"serving {re.escape(name)}@(\d)", net.text(role))[1])
                   for role in ROUTER_WORKERS}
        peer = {slot: (await net.client.find_providers(serve_key(f"{name}@{slot}")))[0]
                for slot in (0, 1)}
        t1 = time.perf_counter()
        asks = []
        for p, n in traffic["migrate"]:
            asks.append(asyncio.create_task(_ask_backend(net.client, peer[0], f"{name}@0", p, n)))
            await asyncio.sleep(ORDER_GAP_S)
        migrate = [t for t, _ in await asyncio.wait_for(asyncio.gather(*asks), NODE_WAIT_S)]
        migrate_s = time.perf_counter() - t1
        snap("before_warm")
        t2 = time.perf_counter()
        warm = await asyncio.wait_for(_timed_ask(net.client, name, *traffic["family"][0]),
                                      NODE_WAIT_S)
        snap("after_warm")
        await asyncio.sleep(2 * LOAD_REPORT_S + 0.5)  # the holder's digest reaches the router
        burst = await asyncio.wait_for(asyncio.gather(*(
            _timed_ask(net.client, name, p, n) for p, n in traffic["family"][1:])), NODE_WAIT_S)
        snap("after_burst")
        pull_s = time.perf_counter() - t2
        # The family's puller holds serve_prefix's heads; the holder, which
        # has pulled nothing, is stamped to pull the last family's chain.
        held = {r: _delta(snaps["after_warm"][r], snaps["before_warm"][r], "launches",
                          "requests") for r in ROUTER_WORKERS}
        holder_slot = slot_of[max(held, key=held.get)]
        src, dst = 1 - holder_slot, holder_slot
        t3 = time.perf_counter()
        prefix = {}
        for i in range(4):
            prefix[i], _ = await asyncio.wait_for(_ask_backend(
                net.client, peer[src], f"{name}@{src}", prefix_prompts[i], prefix_new[i]),
                NODE_WAIT_S)
        stamped = await asyncio.wait_for(net.client.request(
            peer[dst], PROTOCOL_GENERATE, GenerateRequest(
                serve_name=f"{name}@{dst}", prompts=[prefix_prompts[7]],
                max_new_tokens=prefix_new[7], pull_peer=peer[src],
                pull_serve=f"{name}@{src}"), timeout=NODE_WAIT_S), NODE_WAIT_S)
        prefix[7] = stamped.tokens[0]
        await asyncio.sleep(2 * LOAD_REPORT_S + 0.5)
        rest = [i for i in range(4, len(prefix_prompts)) if i != 7]
        routed = await asyncio.wait_for(asyncio.gather(*(
            _timed_ask(net.client, name, prefix_prompts[i], prefix_new[i]) for i in rest)),
            NODE_WAIT_S)
        prefix.update({i: t[0] for i, (t, _, _) in zip(rest, routed)})
        prefix_s = time.perf_counter() - t3
    finally:
        sampling.set()
        if sampler is not None:
            await sampler
        await net.stop()
    sched = net.text("scheduler").splitlines()
    router = [json.loads(line.split(f"serving {name} router: ", 1)[1]) for line in sched
              if f"serving {name} router: " in line]
    return dict(
        migrate=migrate, family=[t[0] for t, _, _ in [warm, *burst]],
        prefix=[prefix[i] for i in range(len(prefix_prompts))], bring_up_s=bring_up_s,
        migrate_traffic_s=migrate_s, pull_traffic_s=pull_s, prefix_traffic_s=prefix_s,
        warm_latency_s=warm[1], burst_latency_s=[lat for _, lat, _ in burst],
        slot_of=slot_of, stamped_pull=dict(puller_slot=dst, holder_slot=src), snaps=snaps,
        workers={role: net.worker_report(role) for role in ROUTER_WORKERS},
        blocks={role: fleet_log(net.text(role)) for role in ROUTER_WORKERS},
        router=router[-1] if router else None, device_mem_mib=mem_peak[0] if sampler else None,
        exits=net.exits, stop_s=net.stop_s, leftover=net.leftover(),
        logs={role: str(path) for role, path in net.logs.items()},
    )


def fleet_summary(run: dict, block_bytes: int) -> dict:
    """What the phase reports from ``run_serve_fleet``'s result: the pull
    (who held, who pulled, the prefill forwards of the cold and the pulled
    request, the pulled request's launches by route), the block plane's
    counts and each worker's pulls and migrations with their failures."""
    s = run["snaps"]
    holder = next((r for r in ROUTER_WORKERS if _delta(
        s["after_warm"][r], s["before_warm"][r], "launches", "requests") > 0), None)
    puller = next((r for r in ROUTER_WORKERS if _delta(
        s["after_burst"][r], s["after_warm"][r], "cache", "remote_prefix_hits") > 0), None)
    out = dict(holder=holder, puller=puller, block_bytes=block_bytes)
    if holder is not None:
        out["cold_prefill_forwards"] = _delta(s["after_warm"][holder], s["before_warm"][holder],
                                              "cache", "prefill_chunks")
    if puller is not None:
        a, b = s["after_burst"][puller], s["after_warm"][puller]
        out.update(
            pulled_requests=_delta(a, b, "launches", "requests"),
            pulled_prefill_forwards=_delta(a, b, "cache", "prefill_chunks"),
            pulled_launches={k: _delta(a, b, "launches", k) for k in ("mma", "simt", "decode")})
    counts = {}
    for role, w in run["workers"].items():
        cache = w["cache"] or {}
        counts[role] = {k: cache.get(k) for k in (
            "remote_prefix_hits", "remote_prefix_misses", "blocks_shipped",
            "block_bytes_shipped", "migrations", "migrated_out", "requeued", "transfer_chosen",
            "recompute_chosen", "preemptions", "hit_blocks")}
    out["counts"] = counts
    blocks = run["blocks"]
    out["pulls"] = {r: b["pulls"] for r, b in blocks.items()}
    out["migrations"] = {r: b["migrations"] for r, b in blocks.items()}
    fails = [f for b in blocks.values() for f in b["pull_failed"]]
    mfails = [f for b in blocks.values() for f in b["migrate_failed"]]
    out["frame_cap"] = dict(
        pull_failures=sum(f["frame_cap"] for f in fails),
        pull_failure_s=sum(f["s"] for f in fails if f["frame_cap"]),
        pull_blocks_asked=[f["blocks_asked"] for f in fails if f["frame_cap"]],
        migrate_failures=sum(f["frame_cap"] for f in mfails),
        migrate_failure_s=sum(f["s"] for f in mfails if f["frame_cap"]),
        migrate_blocks=[f["blocks"] for f in mfails if f["frame_cap"]],
        other_failures=[f["error"] for f in fails + mfails if not f["frame_cap"]])
    return out


def serve_fleet_problems(run: dict, summary: dict, *, want: dict, want_prefix: list,
                         layers: int, device: str) -> list:
    """The gates of the serve_fleet phase: every answer (the dry-pool
    requests, the family, serve_prefix's 16) equal to the in-process
    reference's (``fleet_reference``; ``serve_prefix``'s for its 16);
    a pull landed (hits on the puller; blocks shipped by the holder, each
    ``block_bytes``) and its request ran fewer prefill forwards than the
    cold one, each on the mma route; a migration acked; each worker's
    launch gates (``launch_problems``); exits 0 and no leftovers."""
    problems = []
    for what, got, ref in (("the dry-pool requests", run["migrate"], want["migrate"]),
                           ("the family", run["family"], want["family"]),
                           ("serve_prefix's requests", run["prefix"], want_prefix)):
        bad = [j for j, (a, b) in enumerate(zip(got, ref)) if a != b]
        if bad or len(got) != len(ref):
            problems.append(f"{what}: answers {bad} differ from the in-process pool's")
    puller, holder = summary.get("puller"), summary.get("holder")
    if puller is None or holder is None:
        problems.append(f"no fleet pull landed (holder {holder}, puller {puller})")
    else:
        shipped = summary["counts"][holder]
        if not shipped["blocks_shipped"] or (shipped["block_bytes_shipped"]
                                             != shipped["blocks_shipped"] * summary["block_bytes"]):
            problems.append(f"{holder} shipped {shipped}")
        per_request = summary["pulled_prefill_forwards"] / max(summary["pulled_requests"], 1)
        if not per_request < summary["cold_prefill_forwards"]:
            problems.append(f"the pulled request ran {per_request} prefill forwards, the cold one "
                            f"{summary['cold_prefill_forwards']}")
        lc = summary["pulled_launches"]
        if device == "cuda" and (lc["simt"] or lc["mma"] != layers
                                 * summary["pulled_prefill_forwards"]):
            problems.append(f"the chunks after the pulled prefix launched {lc}")
    if not any(c["migrations"] for c in summary["counts"].values()) or not any(
            summary["migrations"].values()):
        problems.append("no migration acked")
    for role, report in run["workers"].items():
        problems += launch_problems(role, report["launches"], report["kernel_builds"],
                                    layers=layers, device=device)
    problems += exit_problems(run, ROUTER_ROLES)
    if run["leftover"]:
        problems.append(f"left in the work root: {run['leftover']}")
    return problems


def serve_fleet_phase(fleet_ref: dict, prefix: dict) -> dict:
    """The fleet prefix cache and KV migration at Llama-2-7B widths: two workers
    behind the router, each a process of its own started from TOML by the
    port's CLI (``run_serve_fleet``), held to ``serve_fleet_problems``."""
    root = Path(tempfile.mkdtemp(prefix="hsf"))
    t0 = time.perf_counter()
    try:
        run = asyncio.run(run_serve_fleet(root, FLEET_JOB, fleet_ref["traffic"],
                                          prefix["prompts"], prefix["n_new"]))
        # One block's bytes: layers x (K, V) x 16 positions x 32 heads x 128 x bf16.
        summary = fleet_summary(run, prefix["layers"] * 2 * 16 * 32 * 128 * 2)
        problems = serve_fleet_problems(run, summary, want=fleet_ref, want_prefix=prefix["answers"],
                                        layers=prefix["layers"], device="cuda")
        if problems:
            logs = {r: Path(p).read_text(errors="replace")[-3000:] for r, p in run["logs"].items()}
            emit({"phase": "serve_fleet", "summary": summary, "problems": problems})
            raise SystemExit(f"serve_fleet: {problems}\n{json.dumps(logs, indent=1)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    keep = ("bring_up_s", "migrate_traffic_s", "pull_traffic_s", "prefix_traffic_s",
            "warm_latency_s", "burst_latency_s", "slot_of", "router", "device_mem_mib",
            "stop_s", "exits")
    return dict(answers_equal=True, in_process_migrations=fleet_ref["migrate_events"],
                stamped_pull=run["stamped_pull"], **summary,
                directory_entries=(run["router"] or {}).get("directory_entries"),
                launches={r: w["launches"] for r, w in run["workers"].items()},
                peak_mem_gib={r: w["peak_mem_gib"] for r, w in run["workers"].items()},
                seconds=time.perf_counter() - t0, **{k: run[k] for k in keep})


def profile_phase(model) -> dict:
    """A steady decode step and a prefill chunk at the serving shape (8
    lanes, 512 cached positions each): host wall time per forward, and the
    device time the profiler sees, by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from hypha_tpu_torch.executor.generate import logits_of
    from hypha_tpu_torch.ops.kvcache import KVCache
    from hypha_tpu_torch.ops.paged_attention import _decode_splits, _sm_count, ragged_paged_attention

    # n forwards timed on the host clock, n_prof of them under the profiler
    # (its records cost host seconds per launch: 2604 a forward at 32 layers).
    B, per_lane, n, n_prof = 8, 32, 10, 4
    layers = model.config.num_layers
    splits = _decode_splits(B, model.config.num_kv_heads, 1024 // 16, 16,
                            _sm_count(torch.cuda.current_device()))
    # Launches of each ragged kernel per forward, by shape.
    want = {"decode_step": {"ragged_decode_kernel": layers,
                            "ragged_decode_merge_kernel": layers if splits > 1 else 0},
            "prefill_chunk": {"ragged_mma_kernel": layers}}
    out, problems = {"decode_splits": splits}, []
    for label, S in (("decode_step", 1), ("prefill_chunk", 64)):
        with torch.inference_mode():
            cache = KVCache.for_model(model, B, 1024, per_row=True, blocks=512, block_size=16,
                                      ragged=True)
            cache.table[:, : per_lane + 4] = torch.arange(
                B * (per_lane + 4), dtype=torch.int32, device="cuda").reshape(B, -1) % 512
            tok = torch.zeros((B, S), dtype=torch.int64, device="cuda")

            def forward():
                cache.idx.fill_(per_lane * 16 - S)
                return logits_of(model(tok, cache))[:, -1].argmax(dim=-1)

            for _ in range(3):
                forward()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                forward()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / n * 1e3
            # The wrapper counts its launches over the same window; when the
            # profiler's records hold fewer ragged kernels (CUPTI can lose an
            # activity record), the window is profiled once more.
            for _ in range(2):
                launched = ragged_paged_attention.launches
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(n_prof):
                        forward()
                    torch.cuda.synchronize()
                launched = ragged_paged_attention.launches - launched
                # Device-side events only: CPU ops report their kernels' time too.
                events = [e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and e.self_device_time_total > 0]
                recorded = sum(e.count for e in events
                               if any(r in e.key for r in RAGGED_NAMES if "merge" not in r))
                if recorded == launched:
                    break
                out.setdefault("incomplete", []).append(
                    {"label": label, "recorded": recorded, "launched": launched})
        rows = [(e.key, e.self_device_time_total / n_prof / 1e3, e.count // n_prof)
                for e in events]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        by_name = {name: {"ms": sum(ms for k, ms, _ in rows if name in k),
                          "launches": sum(c for k, _, c in rows if name in k)}
                   for name in RAGGED_NAMES}
        attn = sum(v["ms"] for v in by_name.values())
        out[label] = dict(wall_ms=wall_ms, device_busy_ms=busy, idle_share=1 - busy / wall_ms,
                          attention_kernel_ms=attn, ragged_kernels=by_name,
                          kernels_per_forward=sum(r[2] for r in rows),
                          top=[{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in rows[:6]])
        for name, launches in want[label].items():
            got = by_name[name]
            if got["launches"] != launches or (launches and got["ms"] <= 0):
                problems.append(f"{label}: {name} {got}, wanted {launches} launches a forward")
    if problems:
        emit({"phase": "profile", **out, "problems": problems})
        raise SystemExit("profile: " + "; ".join(problems))
    return out


def reference_phase(model) -> dict:
    """The 7B decode forward through the kernel against the training
    forward, and a tiny f32 pool against one-shot generate."""
    from hypha_tpu_torch.executor.generate import generate
    from hypha_tpu_torch.executor.pool import DecodePool
    from hypha_tpu_torch.ops.kvcache import KVCache
    from hypha_tpu_torch.worker.infer_executor import load_model

    with torch.inference_mode():
        ids = torch.tensor(make_prompts(99, [64])[0], device="cuda")[None, :]
        dense = model(ids)
        cache = KVCache.for_model(model, 1, 1024, per_row=True, blocks=64, block_size=16, ragged=True)
        cache.table[0, :4] = torch.arange(4, dtype=torch.int32)
        paged = model(ids, cache)
    finite = bool(torch.isfinite(paged).all())
    err = (paged - dense).abs().max().item()
    scale = dense.abs().max().item()
    argmax_agree = (paged.argmax(-1) == dense.argmax(-1)).float().mean().item()

    # Tiny, but with the kernel's head_dim of 64 (4 query heads, 2 kv heads).
    tiny = load_model({"family": "llama", "preset": "tiny", "serve_dtype": "float32", "seed": 3,
                       "config": {"dtype": "float32", "hidden_size": 256}})
    prompts = make_prompts(5, [3, 17, 40], vocab=tiny.config.vocab_size)
    ref = [generate(tiny, [p], 20)[0].tolist() for p in prompts]
    pool = DecodePool(tiny, slots=4, max_len=128, steps_per_call=4, block_size=8,
                      num_blocks=12, prefill_chunk=16, reserve_blocks=1, ragged=True)
    try:
        got = [f.result(timeout=300)[0] for f in [pool.submit([p], 20) for p in prompts]]
    finally:
        pool.close()
    res = dict(llama7b_logits_max_abs_err=err, llama7b_logits_max_abs=scale,
               llama7b_argmax_agreement=argmax_agree, finite=finite,
               tiny_f32_pool_equals_generate=got == ref, tiny_preemptions=pool.preemptions)
    # Random-weight logits sit close together, so bf16 rounding in the
    # plain path (logits in bf16, then f32) flips some near-tied argmaxes:
    # 60 of 64 positions agreed, max error 2% of the largest logit, on the
    # first H100 run.
    if not finite or got != ref or argmax_agree < 0.75 or err > 0.05 * scale:
        emit({"phase": "reference", **res})
        raise SystemExit("the port disagrees with its reference")
    return res


# ------------------------------------------------------ flash kernel phase


def flash_case(gen, *, B, Sq, Sk, H, Hkv, D, **_):
    def t(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    return t(B, Sq, H, D), t(B, Sk, Hkv, D), t(B, Sk, Hkv, D), t(B, Sq, H, D)


def rel_err(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item() / max(ref.float().abs().max().item(), 1e-30)


def flash_kernel_phase() -> dict:
    """Each flash kernel against its plain version, then timed at the
    training shape (B 2, S 2048, 32 heads, head_dim 128, causal)."""
    from hypha_tpu_torch.ops.flash_attention import (
        flash_dkv_cuda,
        flash_dkv_reference,
        flash_dq_cuda,
        flash_dq_reference,
        flash_forward_cuda,
        flash_forward_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    train_shape = dict(B=2, Sq=2048, Sk=2048, H=32, Hkv=32, D=128, causal=True)
    cases = [
        train_shape,
        dict(B=1, Sq=2048, Sk=2048, H=32, Hkv=8, D=128, causal=True),
        dict(B=1, Sq=2048, Sk=2048, H=32, Hkv=32, D=128, causal=False),
        dict(B=1, Sq=1000, Sk=1000, H=32, Hkv=8, D=128, causal=True),
        dict(B=1, Sq=1000, Sk=1000, H=32, Hkv=32, D=64, causal=False),
        dict(B=1, Sq=1000, Sk=2048, H=32, Hkv=8, D=64, causal=False),
        dict(B=1, Sq=2048, Sk=1000, H=32, Hkv=32, D=128, causal=False),
        dict(B=1, Sq=2048, Sk=2048, H=32, Hkv=8, D=64, causal=True),
        # Sliding windows: Mistral-7B's (4096, GQA 32/8) past its length,
        # and a short one over ragged tiles, causal and not.
        dict(B=1, Sq=4608, Sk=4608, H=32, Hkv=8, D=128, causal=True, window=4096),
        dict(B=1, Sq=1000, Sk=1000, H=32, Hkv=8, D=64, causal=True, window=100),
        dict(B=1, Sq=1000, Sk=1000, H=32, Hkv=32, D=128, causal=False, window=100),
    ]
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    results = []
    for c in cases:
        q, k, v, do = flash_case(gen, **c)
        causal, window = c["causal"], c.get("window")
        o, lse = flash_forward_cuda(q, k, v, causal, None, window)
        dq = flash_dq_cuda(q, k, v, o, lse, do, causal, None, window)
        dk, dv = flash_dkv_cuda(q, k, v, o, lse, do, causal, None, window)
        torch.cuda.synchronize()
        dk2, dv2 = flash_dkv_cuda(q, k, v, o, lse, do, causal, None, window)
        dq2 = flash_dq_cuda(q, k, v, o, lse, do, causal, None, window)
        o2, lse2 = flash_forward_cuda(q, k, v, causal, None, window)
        torch.cuda.synchronize()
        deterministic = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
        dq_identical = bool(torch.equal(dq, dq2))
        fwd_identical = bool(torch.equal(o, o2) and torch.equal(lse, lse2))
        del o2, lse2, dq2, dk2, dv2
        o_ref, lse_ref = flash_forward_reference(q, k, v, causal, None, window)
        r = dict(c, o_err=(o.float() - o_ref.float()).abs().max().item(),
                 lse_err=(lse - lse_ref).abs().max().item())
        del o_ref, lse_ref
        dq_ref = flash_dq_reference(q, k, v, o, lse, do, causal, None, window)
        r.update(dq_rel=rel_err(dq, dq_ref), dq_err=(dq.float() - dq_ref.float()).abs().max().item())
        del dq_ref
        dk_ref, dv_ref = flash_dkv_reference(q, k, v, o, lse, do, causal, None, window)
        r.update(dk_rel=rel_err(dk, dk_ref), dv_rel=rel_err(dv, dv_ref),
                 dkv_err=max((dk.float() - dk_ref.float()).abs().max().item(),
                             (dv.float() - dv_ref.float()).abs().max().item()))
        del dk_ref, dv_ref
        torch.cuda.empty_cache()
        ok = (r["o_err"] <= FLASH_TOL["o"] and r["lse_err"] <= FLASH_TOL["lse"]
              and max(r["dq_rel"], r["dk_rel"], r["dv_rel"]) <= FLASH_TOL["grad_rel"]
              and deterministic and dq_identical and fwd_identical
              and bool(torch.isfinite(lse).all()))
        r.update(dkv_bit_identical=deterministic, dq_bit_identical=dq_identical,
                 fwd_bit_identical=fwd_identical, ok=ok)
        results.append(r)
        errs["fwd"] = max(errs["fwd"], r["o_err"])
        errs["dq"] = max(errs["dq"], r["dq_err"])
        errs["dkv"] = max(errs["dkv"], r["dkv_err"])
        if not ok:
            emit({"phase": "flash_kernels", "failed_case": r, "tol": FLASH_TOL})
            raise SystemExit("a flash kernel disagrees with its plain version")

    # Timing at the training shape.
    c = train_shape
    B, S, H, Hkv, D = c["B"], c["Sq"], c["H"], c["Hkv"], c["D"]
    q, k, v, do = flash_case(gen, **c)
    o, lse = flash_forward_cuda(q, k, v, True)
    timing = {
        "fwd": dict(ms=time_ms(lambda: flash_forward_cuda(q, k, v, True), reps=3, iters=5),
                    plain_ms=time_ms(lambda: flash_forward_reference(q, k, v, True), reps=3, iters=3)),
        "dq": dict(ms=time_ms(lambda: flash_dq_cuda(q, k, v, o, lse, do, True), reps=3, iters=5),
                   plain_ms=time_ms(lambda: flash_dq_reference(q, k, v, o, lse, do, True),
                                    reps=3, iters=3)),
        "dkv": dict(ms=time_ms(lambda: flash_dkv_cuda(q, k, v, o, lse, do, True), reps=3, iters=5),
                    plain_ms=time_ms(lambda: flash_dkv_reference(q, k, v, o, lse, do, True),
                                     reps=3, iters=3)),
    }
    # Yardstick only, never called by the port: SDPA forward, and its
    # backward (one call giving dQ, dK and dV) on a retained graph. Timed
    # as (forward + backward) - forward it read 0.48-0.82 ms from machine
    # to machine.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, doh = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    sdpa_fwd = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (qh, kh, vh))
    out = sdpa(qg, kg, vg, is_causal=True)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), doh, retain_graph=True))
    del out
    timing["fwd"]["library_ms"] = sdpa_fwd
    timing["dq"]["library_ms"] = timing["dkv"]["library_ms"] = sdpa_bwd
    # The least time for the same work: every visible (query, key) pair
    # costs 4 D flops forward (QK^T, PV), 6 D in dQ (QK^T, dO V^T, dS K) and
    # 8 D in dK/dV (QK^T, dO V^T, P^T dO, dS^T Q); each input is read once
    # and each output written once.
    pairs = B * H * S * (S + 1) // 2
    x = B * S * H * D * 2  # one bf16 [B, S, H, D] tensor
    xkv = B * S * Hkv * D * 2
    lbytes = B * H * S * 4
    work = {"fwd": (4 * D * pairs, 2 * x + 2 * xkv + lbytes),
            "dq": (6 * D * pairs, 4 * x + 2 * xkv + lbytes),
            "dkv": (8 * D * pairs, 3 * x + 4 * xkv + lbytes)}
    for key, (ops, nbytes) in work.items():
        t_ops = ops / PEAK_OPS[torch.bfloat16] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        tm = timing[key]
        tm.update(ops=ops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                  bound_by="operations" if t_ops >= t_bytes else "bytes",
                  achieved_TFLOPs=ops / tm["ms"] / 1e9, max_abs_err=errs[key])
    emit({"phase": "flash_kernels", "cases": results, "tol": FLASH_TOL, "timing": timing,
          "shape": "B=2 S=2048 Hq=Hkv=32 D=128 causal bf16",
          "library": "scaled_dot_product_attention; dq and dkv carry its whole backward"})
    return timing


# -------------------------------------------------------------- train phase


class Scheduler:
    """The scheduler's side of the progress protocol for one worker: it
    asks for ``steps`` inner steps a round for ``rounds`` rounds, and
    records the time of every STATUS heartbeat and of every round boundary
    (UPDATE -> UPDATE_RECEIVED) on its own clock."""

    def __init__(self, *, rounds, steps):
        self.rounds, self.steps = rounds, steps
        self.done = self.batches = 0
        self.scheduled = False
        self.marks: list = []  # (round, time) at every STATUS
        self.update_s: list = []
        self.metrics: list = []  # the METRICS of every round
        self.t_update = 0.0

    def on_status(self, now):
        """Called at every STATUS, before it is answered."""

    def on_round_end(self):
        """Called at every UPDATE_RECEIVED, before it is answered."""

    def answer(self, progress):
        from hypha_tpu_torch.messages import ProgressKind, ProgressResponse, ProgressResponseKind

        now = time.perf_counter()
        if progress.kind == ProgressKind.STATUS:
            self.marks.append((self.done, now))
            self.on_status(now)
            if self.done >= self.rounds:
                return ProgressResponse(kind=ProgressResponseKind.DONE)
            self.batches += 1
            if not self.scheduled and self.batches >= self.steps:
                self.scheduled = True
                return ProgressResponse(kind=ProgressResponseKind.SCHEDULE_UPDATE, counter=0)
            return ProgressResponse(kind=ProgressResponseKind.CONTINUE)
        if progress.kind == ProgressKind.UPDATE:
            self.t_update = now
        if progress.kind == ProgressKind.METRICS:
            self.metrics.append((progress.round, dict(progress.metrics)))
        if progress.kind == ProgressKind.UPDATE_RECEIVED:
            self.on_round_end()
            self.update_s.append(now - self.t_update)
            self.done += 1
            self.batches, self.scheduled = 0, False
            kind = ProgressResponseKind.DONE if self.done >= self.rounds else ProgressResponseKind.CONTINUE
            return ProgressResponse(kind=kind)
        return ProgressResponse(kind=ProgressResponseKind.OK)

    def step_ms(self) -> list:
        """Intervals between consecutive STATUS calls inside a round: one
        inner step each (forward, backward, update, loss read)."""
        out = []
        for (r0, t0), (r1, t1) in zip(self.marks, self.marks[1:]):
            if r0 == r1:
                out.append((t1 - t0) * 1e3)
        return out


class TrainSession(Scheduler):
    """An in-process scheduler and parameter server behind the bridge
    client's four methods. The server runs each round through
    ``ps_round`` on the card (lr 0.7, μ 0.9), checks after every merge that
    the trainer's parameters equal θ_t + update, records step times, and
    profiles one steady inner step (neither a round's first nor its last).
    The wrappers count the flash launches of the same window; when the
    profiler's records hold fewer (CUPTI can lose an activity record), the
    window is kept in ``self.incomplete`` and the next steady step, of this
    round or the next, is profiled instead."""

    def __init__(self, work_dir, slices, *, rounds, steps, outer):
        super().__init__(rounds=rounds, steps=steps)
        self.dir = work_dir
        self.slices = slices
        self.outer = outer
        self.fetches = 0
        self.events: "queue.Queue[dict]" = queue.Queue()
        self.model = None  # captured when run_training builds it
        self.before = self.update = None
        self.merge_rel_err: list = []
        self.times: list = []  # ps_round's seconds, a dict a round
        self.prof = None
        self.prof_t0 = 0.0
        self.prof_counts: dict = {}
        self.profile = None
        self.incomplete: list = []  # profiled steps whose records missed a launch

    def fetch(self, ref):
        path = self.slices[self.fetches % len(self.slices)]
        self.fetches += 1
        return [path.name]

    @staticmethod
    def flash_counts() -> dict:
        from hypha_tpu_torch.ops.flash_attention import flash_attention

        return dict(zip(FLASH_NAMES, (flash_attention.fwd_launches, flash_attention.dq_launches,
                                      flash_attention.dkv_launches)))

    def on_status(self, now):
        from torch.profiler import ProfilerActivity, profile

        if self.prof is not None:
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.prof_t0
            self.prof.__exit__(None, None, None)
            counts = self.flash_counts()
            rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                    for e in self.prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
            rows.sort(key=lambda r: -r[1])
            self.prof = None
            step = dict(
                wall_ms=wall * 1e3, device_busy_ms=sum(r[1] for r in rows),
                kernels={name: sum(ms for k, ms, _ in rows if name in k) for name in FLASH_NAMES},
                launches={name: sum(c for k, _, c in rows if name in k) for name in FLASH_NAMES},
                wrapper_launches={n: counts[n] - self.prof_counts[n] for n in FLASH_NAMES},
                top=[{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in rows[:8]],
            )
            last = self.done >= 1 and self.batches >= self.steps - 1
            if step["launches"] == step["wrapper_launches"] or last:
                self.profile = step
            else:
                self.incomplete.append(step)
        # A round's steps from its second on (round 0's first warms up; the
        # last status of a round schedules the update, so the windows end
        # before it): up to 2 (steps - 2) windows to find one whose records
        # hold every launch.
        if (self.done < 2 and 1 <= self.batches < self.steps - 1 and self.prof is None
                and self.profile is None):
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.prof_counts = self.flash_counts()
            self.prof_t0 = time.perf_counter()

    def on_round_end(self):
        self.check_merge()

    def send_status(self, progress):
        return self.answer(progress)

    def send_resource(self, send, path, resource="updates", meta=None):
        from hypha_tpu_torch.executor.serialization import load_file, read_header

        # θ_t on the host, to check the merge against: the tensors the
        # delta carries (every parameter, or a LoRA job's adapters).
        names = [_torch_name(n) for n in read_header(self.dir / path)[0]]
        state = self.model.state_dict()
        self.before = {k: state[k].detach().to("cpu", copy=True) for k in names}
        out, _, _, times = ps_round(self.dir / path, float(meta["num_samples"]), int(meta["round"]),
                                    self.dir / "momentum.safetensors", self.dir, self.outer, "cuda")
        self.times.append(times)
        self.update = load_file(out)
        self.events.put({"path": out.name, "meta": {"round": meta["round"]}})

    @contextmanager
    def receive(self, ref):
        def gen():
            while True:
                try:
                    yield self.events.get(timeout=600)
                except queue.Empty:
                    return

        yield gen()

    def check_merge(self):
        from hypha_tpu_torch.models.convert import flat_to_state

        update = flat_to_state(self.update)
        state = self.model.state_dict()
        worst = 0.0
        with torch.no_grad():
            for name in self.before:
                p = state[name]
                want = self.before[name].to(p.device).float() + update[name].to(p.device).float()
                err = (p.float() - want).abs().max().item()
                worst = max(worst, err / max(want.abs().max().item(), 1e-30))
        self.merge_rel_err.append(worst)
        self.before = self.update = None


def write_slices(work_dir, *, n_slices, per_slice, seq, period, seed) -> list:
    """Counting sequences (token t+1 follows t, modulo ``period``) from
    random offsets, as SafeTensors slices. With a period below the
    sequence length each sequence repeats, so the next token is learnable
    from the current one and from the copy one period back."""
    from hypha_tpu_torch.executor.serialization import save_file

    g = torch.Generator().manual_seed(seed)
    paths = []
    for i in range(n_slices):
        start = torch.randint(0, period, (per_slice, 1), generator=g)
        ids = ((start + torch.arange(seq)) % period).to(torch.int32)
        path = work_dir / f"slice-{i}.safetensors"
        save_file({"input_ids": ids}, path)
        paths.append(path)
    return paths


def train_spec(job_id: str, model: dict, *, batch: int, lr: float, **options):
    """A DiLoCo train job: slices from ``file:///slices`` (which the
    stand-ins serve in turn), deltas to and updates from peer ``ps``;
    ``options`` are further ``TrainExecutorConfig`` fields."""
    from hypha_tpu_torch.messages import (
        Adam,
        Executor,
        Fetch,
        JobSpec,
        Receive,
        Reference,
        Send,
        TrainExecutorConfig,
    )

    return JobSpec(job_id=job_id, executor=Executor(
        kind="train", name="diloco-transformer", train=TrainExecutorConfig(
            model=model,
            data=Fetch(Reference.from_uri("file:///slices")),
            updates=Send(Reference.from_peers(["ps"], "updates")),
            results=Receive(Reference.from_peers(["ps"], "results")),
            optimizer=Adam(lr=lr), batch_size=batch, **options,
        )))


# Llama-2-7B widths cut to TRAIN_LAYERS layers, seeded random weights.
TRAIN_MODEL = {"model_type": "causal-lm", "family": "llama", "preset": "llama2-7b",
               "seed": 0, "config": {"num_layers": TRAIN_LAYERS, "remat": True}}


def train_phase() -> dict:
    """run_training at Llama-2-7B widths, cut to ``TRAIN_LAYERS`` layers."""
    import hypha_tpu_torch.executor.training as training
    from hypha_tpu_torch.messages import Nesterov
    from hypha_tpu_torch.ops.attention import dot_product_attention
    from hypha_tpu_torch.ops.flash_attention import flash_attention

    work_dir = Path(tempfile.mkdtemp(prefix="chip-smoke-train-"))
    try:
        steps_total = TRAIN_ROUNDS * TRAIN_STEPS
        slices = write_slices(work_dir, n_slices=2, per_slice=steps_total * TRAIN_BATCH // 2,
                              seq=TRAIN_SEQ, period=TRAIN_PERIOD, seed=5)
        session = TrainSession(work_dir, slices, rounds=TRAIN_ROUNDS, steps=TRAIN_STEPS,
                               outer=Nesterov())
        spec = train_spec("chip-smoke-train", TRAIN_MODEL, batch=TRAIN_BATCH, lr=3e-4)
        build = training.build_model

        def capture(model_spec, device=None, attn_impl=None):
            model, cfg = build(model_spec, device=device, attn_impl=attn_impl)
            session.model = model
            return model, cfg

        training.build_model = capture
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.fwd_launches = flash_attention.dq_launches = 0
        flash_attention.dkv_launches = flash_attention.plain_calls = 0
        dot_product_attention.calls = 0
        t0 = time.perf_counter()
        try:
            result = training.run_training(session, work_dir, spec)
        finally:
            training.build_model = build
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fwd": flash_attention.fwd_launches, "dq": flash_attention.dq_launches,
                    "dkv": flash_attention.dkv_launches}
        plain = {"flash_plain_calls": flash_attention.plain_calls,
                 "dot_product_attention_calls": dot_product_attention.calls}
        model = session.model
        n_params = sum(p.numel() for p in model.parameters())
        cfg = model.config
        session.model = None
        del model
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    losses = result.losses
    first = losses[:TRAIN_STEPS]
    last = losses[-TRAIN_STEPS:]
    steps = session.step_ms()
    step_ms = statistics.median(steps)
    prof = session.profile or {}
    res = dict(
        model="llama2-7b", cut=f"num_layers 32 -> {TRAIN_LAYERS} (full widths: hidden "
        f"{cfg.hidden_size}, heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, "
        f"intermediate {cfg.intermediate_size}, vocab {cfg.vocab_size})",
        params=n_params, seq=TRAIN_SEQ, batch=TRAIN_BATCH, rounds=result.rounds,
        inner_steps=result.batches, remat=cfg.remat, param_dtype="float32",
        compute_dtype=cfg.dtype, losses=losses, first_round_mean=sum(first) / len(first),
        last_round_mean=sum(last) / len(last), step_ms=step_ms, step_ms_all=steps,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, wall_s=wall,
        update_phase_s=session.update_s, server_s=session.times,
        kernel_launches=launches, **plain, merge_rel_err=session.merge_rel_err,
        profiled_step=prof, profiled_incomplete=session.incomplete,
        device_idle_share=(1 - prof["device_busy_ms"] / step_ms) if prof else None,
    )
    want = {"fwd": 2 * TRAIN_LAYERS * steps_total, "dq": TRAIN_LAYERS * steps_total,
            "dkv": TRAIN_LAYERS * steps_total}
    problems = []
    if not all(torch.isfinite(torch.tensor(losses))) or len(losses) != steps_total:
        problems.append(f"losses {losses}")
    if not res["last_round_mean"] < res["first_round_mean"]:
        problems.append("the last round's mean loss is not below the first's")
    if launches != want:
        problems.append(f"kernel launches {launches}, wanted {want}")
    if any(plain.values()):
        problems.append(f"plain attention ran on the path: {plain}")
    if len(session.merge_rel_err) != TRAIN_ROUNDS or max(session.merge_rel_err) > 2.0**-23:
        problems.append(f"merge errors {session.merge_rel_err}")
    if (prof.get("launches") != STEP_LAUNCHES or prof.get("wrapper_launches") != STEP_LAUNCHES
            or not all(prof["kernels"][n] for n in FLASH_NAMES)):
        problems.append(f"profiled step: flash launches {prof.get('launches')}, by the wrappers "
                        f"{prof.get('wrapper_launches')} (wanted {STEP_LAUNCHES}), device ms "
                        f"{prof.get('kernels')}, incomplete windows {session.incomplete}")
    if problems:
        emit({"phase": "train", **res, "problems": problems})
        raise SystemExit("training phase failed: " + "; ".join(problems))
    return res


# ------------------------------------------- the parameter server's round

CLI_LIMIT_S = 600  # a trainer process must exit within this


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextmanager
def _outer_step_timed(parts: dict, device):
    """Time the parts of ``outer_step`` into ``parts``: its SafeTensors
    reads and writes, its copies to the device and to the host, and its
    f64 norms. Each part is timed between two synchronisations of
    ``device``, so the arithmetic queued before it counts to none of them;
    ``outer_step``'s time less the parts is that arithmetic and the host's
    loop."""
    import hypha_tpu_torch.worker.ps_executor as ps

    def timed(fn, key):
        def call(*args, **kwargs):
            _sync(device)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                _sync(device)
                k = key(*args) if callable(key) else key
                parts[k] = parts.get(k, 0.0) + time.perf_counter() - t0
        return call

    saved = ps.load_file, ps.save_file, ps._copy, ps._sq_sum
    ps.load_file, ps.save_file = timed(ps.load_file, "read_s"), timed(ps.save_file, "write_s")
    ps._copy = timed(ps._copy, lambda t, dev: "to_host_s" if torch.device(dev).type == "cpu"
                     else "to_device_s")
    ps._sq_sum = timed(ps._sq_sum, "norms_s")
    try:
        yield parts
    finally:
        ps.load_file, ps.save_file, ps._copy, ps._sq_sum = saved


def ps_round(path: Path, samples: float, round_num: int, momentum: Path, work_dir: Path, outer,
             device):
    """The parameter server's round over one worker's Δθ, through the
    port's own modules on ``device``: fold the file into a ``RoundAccum``,
    then ``outer_step`` (the update written into ``work_dir``, the momentum
    file swapped). Returns the update's path, the fold, the step's stats,
    and the seconds of the fold, of the step and of the step's parts
    (``_outer_step_timed``)."""
    from hypha_tpu_torch.stream.accum import RoundAccum
    from hypha_tpu_torch.worker.ps_executor import outer_step

    _sync(device)
    t0 = time.perf_counter()
    accum = RoundAccum(device=device)
    accum.fold(path, samples)
    _sync(device)
    t1 = time.perf_counter()
    stats: dict = {}
    times = {"fold_s": t1 - t0}
    with _outer_step_timed(times, device):
        out = outer_step({"worker": (path, samples)}, momentum, outer.lr, outer.momentum, work_dir,
                         round_num, accum=accum, stats=stats, device=device)
    _sync(device)
    times["outer_step_s"] = time.perf_counter() - t1
    return out, accum, stats, times


def flat_f32_spec(model: dict) -> dict:
    """``{flat name: ("F32", shape)}`` of a model config's Δθ file."""
    from hypha_tpu_torch.models.convert import state_to_flat
    from hypha_tpu_torch.models.registry import build_model

    shapes, _ = build_model(model, device="meta")
    return {k: ("F32", tuple(v.shape)) for k, v in state_to_flat(shapes, shapes.state_dict()).items()}


# ---------------------------------------------------------- train_node phase

NODE_DATASET = "counting"
# The phase's watchdog: the reference's whole-run constant (600 s,
# orchestrator.DEFAULT_STATUS_TIMEOUT) instead of the adaptive per-round
# deadline. On an H100 80GB HBM3 at 700 W a healthy round 1 of this job
# went 65.38 s without a progress message (the parameter server's fold and
# Nesterov step on 7.52 GB, between the worker's METRICS and UPDATED)
# while the adaptive deadline's floor is 60 s: it survived only because
# the trainer's 25 s start-up, still in the mean batch time, lifted that
# round's deadline to 69.21 s. The phase records the adaptive deadline
# beside every gap (``progress_timing``).
NODE_STATUS_TIMEOUT_S = 600.0


@contextmanager
def node_probes(device):
    """Measure the fabric's training rounds from inside the port's modules:
    each Δθ the parameter server saves (its push header, its SafeTensors
    names, dtypes and shapes or its HQD1 frame's codec, tag and shapes,
    its bytes and the seconds from the push's header to the saved file),
    each fold, outer step and broadcast encode (between two
    synchronisations of ``device``), each broadcast (with its fragment
    tag), each Δθ push a worker's connector makes,
    the worker's log lines (the trainer process's output), and the
    scheduler's side: each auction (``GreedyWorkerAllocator.request``),
    each dispatch (``Task.dispatch``), each job status the scheduler hears
    (``StatusRouter``; after the router closes, a recorder takes its place
    so the statuses that follow the job's completion are heard too), each
    slice assigned (``DataScheduler.assign``; its epoch and the peer's
    held window in ``rec["assigned"]``), each failed lease renewal
    (``WorkerHandle._renew``), each deadline the watchdog computes
    (``Orchestrator._effective_timeout``: the one in force and the
    adaptive one), and each progress message with
    its time, the round it belongs to, the batch scheduler's handling time
    and its answer (``BatchScheduler.on_progress``)."""
    import logging

    from hypha_tpu_torch.compress import frame_header
    from hypha_tpu_torch.executor.serialization import read_header
    from hypha_tpu_torch.messages import PROTOCOL_API, Ack, JobStatus, ProgressKind
    from hypha_tpu_torch.scheduler.allocator import GreedyWorkerAllocator
    from hypha_tpu_torch.scheduler.batch_scheduler import BatchScheduler
    from hypha_tpu_torch.scheduler.data_scheduler import DataScheduler
    from hypha_tpu_torch.scheduler.orchestrator import Orchestrator
    from hypha_tpu_torch.scheduler.task import StatusRouter, Task
    from hypha_tpu_torch.scheduler.worker_handle import WorkerHandle
    from hypha_tpu_torch.stream.accum import RoundAccum
    from hypha_tpu_torch.worker import ps_executor
    from hypha_tpu_torch.worker.connectors import Connector

    rec = {"deltas": [], "fold_s": [], "outer_step_s": [], "encode_s": [], "broadcast": [],
           "push": [], "log": [], "fold_files": [], "outer_steps": [], "encodes": [],
           "auctions": [], "dispatch": [], "statuses": [], "slices": [], "renew_failures": [],
           "timeouts": [], "progress": [], "assigned": []}
    PS = ps_executor.ParameterServerExecutor
    saved = (PS._save_delta, ps_executor.outer_step, RoundAccum.fold, PS._broadcast, Connector.send,
             PS._encode_broadcast)
    save_delta, outer, fold, broadcast, send, encode = saved
    sched_saved = (GreedyWorkerAllocator.request, Task.dispatch.__func__, StatusRouter._on_status,
                   StatusRouter.close, DataScheduler.assign, WorkerHandle._renew,
                   Orchestrator._effective_timeout, BatchScheduler.on_progress)
    request, dispatch, on_status, router_close, assign, renew, effective, on_progress = sched_saved
    late: list = []  # the recorders that replace closed routers
    worker_round: dict = {}  # peer -> UPDATE_RECEIVED answered so far

    async def timed_save(push, work_dir, round_num, **kw):
        t0 = time.perf_counter()
        path, samples = await save_delta(push, work_dir, round_num, **kw)
        frame = frame_header(path)
        rec["deltas"].append({
            "round": round_num, "from": push.peer, "s": time.perf_counter() - t0,
            "path": str(path),
            "bytes": path.stat().st_size, "header": dict(push.resource),
            # SafeTensors: {name: (dtype, shape)}; an HQD1 frame: its codec,
            # tag and {name: shape}.
            "tensors": None if frame else {k: (v["dtype"], tuple(v["shape"]))
                                           for k, v in read_header(path)[0].items()},
            "frame": frame and {"codec": frame["codec"], "tag": frame.get("tag"),
                                "tensors": {t["name"]: tuple(t["shape"])
                                            for t in frame["tensors"]}}})
        return path, samples

    def timed(fn, key, ident=None):
        """``fn`` timed between two synchronisations of ``device``; with
        ``ident``, also ``rec[ident[0]]`` gets ``ident[1](args)`` and the
        seconds (which file a fold read, which server's work dir an outer
        step or an encode ran in)."""
        def call(*args, **kwargs):
            _sync(device)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                _sync(device)
                rec[key].append(time.perf_counter() - t0)
                if ident is not None:
                    rec[ident[0]].append({**ident[1](args), "s": rec[key][-1]})
        return call

    async def timed_broadcast(self, cfg, update_path, round_num, elastic=None, extra_header=None,
                              peers_override=None, **kw):
        size, t0 = update_path.stat().st_size, time.perf_counter()
        await broadcast(self, cfg, update_path, round_num, elastic, extra_header, peers_override,
                        **kw)
        to = list(elastic.membership.active) if elastic else None
        rec["broadcast"].append({"round": round_num, "s": time.perf_counter() - t0, "bytes": size,
                                 "header": extra_header, "t0": t0,
                                 "to": peers_override if peers_override is not None else to})

    async def timed_send(self, send_, path, resource, meta=None):
        size, t0 = Path(path).stat().st_size, time.perf_counter()
        await send(self, send_, path, resource, meta)
        rec["push"].append({"round": (meta or {}).get("round"), "s": time.perf_counter() - t0,
                            "bytes": size, "from": getattr(self.node, "peer_id", None),
                            "peers": list(send_.ref.peers or []), "resource": resource,
                            "meta": dict(meta or {})})

    async def timed_request(self, spec, price, timeout, num_workers):
        t0 = time.perf_counter()
        offers = await request(self, spec, price, timeout, num_workers)
        rec["auctions"].append({"t0": t0, "t1": time.perf_counter(),
                                "executor": spec.executor[0].executor_class,
                                "offers": [o.peer_id for o in offers]})
        return offers

    async def timed_dispatch(cls, node, router, spec, workers):
        task = await dispatch(cls, node, router, spec, workers)
        train = spec.executor.train
        rec["dispatch"].append({"t": time.perf_counter(), "job_id": spec.job_id,
                                "kind": spec.executor.kind, "peer": workers[0].peer_id,
                                "batch_size": train.batch_size if train else None})
        return task

    async def heard(peer, status):
        rec["statuses"].append({"t": time.perf_counter(), "peer": peer, "job_id": status.job_id,
                                "state": status.state})

    async def status_seen(self, peer, status):
        await heard(peer, status)
        return await on_status(self, peer, status)

    async def late_status(peer, status):
        await heard(peer, status)
        return Ack(ok=True)

    def close_and_keep_listening(self):
        router_close(self)
        late.append(self._registration._node.on(PROTOCOL_API, JobStatus).respond_with(late_status))

    def counted_assign(self, peer, prefetch=None):
        index = assign(self, peer, prefetch)
        rec["slices"].append((peer, index))
        rec["assigned"].append({"peer": peer, "epoch": self.tracker.epoch, "index": index,
                                "held": len(self.held_of(peer)),
                                "num_slices": self.tracker.num_slices})
        return index

    async def noted_renew(self):
        try:
            return await renew(self)
        except Exception as e:  # noted; node_problems fails on it
            rec["renew_failures"].append(f"{self.peer_id}: {e}")
            raise

    def noted_timeout(self, ctx):
        value = effective(self, ctx)
        # The adaptive deadline too, when the caller set an explicit one.
        explicit, ctx.status_timeout = ctx.status_timeout, None
        try:
            adaptive = effective(self, ctx)
        finally:
            ctx.status_timeout = explicit
        rec["timeouts"].append((time.perf_counter(), value, adaptive))
        return value

    def stamped(self, peer, progress):
        t0 = time.perf_counter()
        resp = on_progress(self, peer, progress)
        ms = (time.perf_counter() - t0) * 1e3
        kind = progress.kind
        own = kind in (ProgressKind.UPDATED, ProgressKind.METRICS)
        rec["progress"].append({"t": t0, "peer": peer, "kind": kind.value,
                                "round": progress.round if own else worker_round.get(peer, 0),
                                "batch_size": progress.batch_size, "ms": ms,
                                "answer": resp.kind.value, "counter": resp.counter,
                                "shard": progress.shard, "sched_round": self.tracker.round,
                                "generation": resp.generation, "resp_round": resp.round})
        if kind == ProgressKind.UPDATE_RECEIVED:
            worker_round[peer] = worker_round.get(peer, 0) + 1
        return resp

    class Lines(logging.Handler):
        def emit(self, record):
            rec["log"].append(record.getMessage())

    logger = logging.getLogger("hypha.torch.worker.process")
    handler, level = Lines(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    PS._save_delta = staticmethod(timed_save)
    ps_executor.outer_step = timed(outer, "outer_step_s", (
        "outer_steps", lambda a: {"work_dir": str(a[4]), "round": a[5]}))
    RoundAccum.fold = timed(fold, "fold_s", (
        "fold_files", lambda a: {"path": str(a[1]), "sign": a[3] if len(a) > 3 else 1.0,
                            "prefolded": bool(a[4]) if len(a) > 4 else False}))
    PS._encode_broadcast = timed(encode, "encode_s", (
        "encodes", lambda a: {"work_dir": str(a[4]), "round": a[5]}))
    PS._broadcast, Connector.send = timed_broadcast, timed_send
    GreedyWorkerAllocator.request, Task.dispatch = timed_request, classmethod(timed_dispatch)
    StatusRouter._on_status, StatusRouter.close = status_seen, close_and_keep_listening
    DataScheduler.assign, WorkerHandle._renew = counted_assign, noted_renew
    Orchestrator._effective_timeout, BatchScheduler.on_progress = noted_timeout, stamped
    try:
        yield rec
    finally:
        PS._save_delta = staticmethod(save_delta)
        ps_executor.outer_step, RoundAccum.fold, PS._broadcast, Connector.send, \
            PS._encode_broadcast = saved[1:]
        GreedyWorkerAllocator.request, Task.dispatch = request, classmethod(dispatch)
        StatusRouter._on_status, StatusRouter.close = on_status, router_close
        DataScheduler.assign, WorkerHandle._renew = assign, renew
        Orchestrator._effective_timeout, BatchScheduler.on_progress = effective, on_progress
        for reg in late:
            reg.close()
        logger.removeHandler(handler)
        logger.setLevel(level)


def node_job(model: dict, *, rounds, steps, batch, lr, workers, **options):
    """The DiLoCo job ``run_node_job`` hands the port's scheduler. Each
    worker asks for ``1 / batch`` of a GPU, and each ``WorkerNode`` offers
    its whole GPU, so the reference's sizing rule (``batch_size_for``:
    floor(offered / required), clamped to ``max_batch_size``) dispatches
    batch ``batch``; a round is ``steps`` batches of every worker.
    ``options`` are further ``DiLoCoJob`` fields (the wire codec, the sync
    mode)."""
    from hypha_tpu_torch.messages import Adam, Nesterov, PriceRange
    from hypha_tpu_torch.resources import Resources
    from hypha_tpu_torch.scheduler.job_config import DiLoCoJob, DiLoCoRounds, JobResources

    return DiLoCoJob(
        model=model, dataset=NODE_DATASET,
        rounds=DiLoCoRounds(update_rounds=rounds, avg_samples_between_updates=steps * batch * workers,
                            max_batch_size=batch),
        inner_optimizer=Adam(lr=lr), outer_optimizer=Nesterov(lr=0.7, momentum=0.9),
        resources=JobResources(
            num_workers=workers, worker=Resources(gpu=1.0 / batch, cpu=1.0, memory=1024),
            parameter_server=Resources(cpu=1.0, memory=1024),
            worker_price=PriceRange(bid=1.0, max=10.0),
            parameter_server_price=PriceRange(bid=1.0, max=10.0)), **options)


async def run_node_job(root: Path, model: dict, *, device, rounds, steps, batch, seq, period,
                       lr=3e-4, limit_s=CLI_LIMIT_S, workers=1, train_runtime="process",
                       status_timeout=None, job_options=None, ps_hosts=1,
                       check_reducer=False, sample_card=False, per_slice=None,
                       n_slices=None, alongside=()) -> dict:
    """The whole port on ``TcpTransport`` at 127.0.0.1 with ephemeral
    ports: a ``Gateway``, a ``DataNode`` serving counting-sequence slices as
    dataset ``counting``, ``workers`` ``WorkerNode``s ``w0``, ``w1``, ...
    (gpu 1 each, offered whole; by default the trainer CLI as a process of
    its own), ``ps_hosts`` ``WorkerNode``s (gpu 0, so never train workers:
    ``psw``, or ``psw0``, ``psw1``, ... when there are several, so that
    the scheduler's distinct-peer auction puts one shard on each) hosting
    the parameter server, everything on ``device``, and the port's
    scheduler: ``Orchestrator(node).run(job)`` on a ``Node`` ``sched`` with
    the JAX CLI's defaults (a 2 s auction; the adaptive watchdog unless
    ``status_timeout`` is given), running ``node_job``. A scheduler failure (``JobFailed``, ``AllocationError``)
    propagates. After ``run`` returns it waits up to ``limit_s`` for every
    job's final status. Returns the ``JobResult`` and what ``node_probes``
    saw (and ``reducer_probes``, with ``check_reducer``; the card's peak
    memory, all processes, with ``sample_card``). ``root`` must be short:
    a trainer's bridge socket lives three levels below it.

    ``per_slice`` cuts the job's samples into slices of that many (two
    slices by default), ``n_slices`` of them (as many as the job's samples
    fill, by default). Each coroutine function of ``alongside`` runs as a
    task beside the job from bring-up, with a dict holding ``rec``,
    ``data`` (the data node), ``started`` (the parts that the end stops),
    ``boot``, ``root`` and ``data_dir``; when the job's statuses are in,
    the dict's ``done`` is set and each task has 30 s to end before it is
    cancelled and the nodes stop. The dict comes back as ``side``. The workers' slice caches (``w*/slice-cache``) are
    not leftovers."""
    from hypha_tpu_torch.data_node import DataNode
    from hypha_tpu_torch.gateway import Gateway
    from hypha_tpu_torch.network import Node, TcpTransport
    from hypha_tpu_torch.resources import Resources
    from hypha_tpu_torch.scheduler.orchestrator import Orchestrator
    from hypha_tpu_torch.worker.arbiter import OfferConfig
    from hypha_tpu_torch.worker.runtime import WorkerNode

    data_dir = root / "data"
    data_dir.mkdir(parents=True)
    samples = rounds * steps * batch * (workers if per_slice else 1)
    per_slice = per_slice or samples // 2
    write_slices(data_dir, n_slices=n_slices or samples // per_slice, per_slice=per_slice,
                 seq=seq, period=period, seed=5)
    job = node_job(model, rounds=rounds, steps=steps, batch=batch, lr=lr, workers=workers,
                   **(job_options or {}))
    listen = ["127.0.0.1:0"]
    gw = Gateway(TcpTransport(), peer_id="gw")
    await gw.start(listen)
    boot = [gw.node.listen_addrs[0]]
    data = DataNode(TcpTransport(), {NODE_DATASET: data_dir}, peer_id="data", bootstrap=boot)
    trainers = [WorkerNode(TcpTransport(), resources=Resources(gpu=1, cpu=8, memory=65536),
                           device=device, peer_id=f"w{i}", train_runtime=train_runtime,
                           offer=OfferConfig(strategy="whole"), bootstrap=boot,
                           work_root=root / f"w{i}") for i in range(workers)]
    ps_names = ["psw"] if ps_hosts == 1 else [f"psw{k}" for k in range(ps_hosts)]
    pss = [WorkerNode(TcpTransport(), resources=Resources(cpu=8, memory=65536), device=device,
                      peer_id=name, bootstrap=boot, work_root=root / name) for name in ps_names]
    node = Node(TcpTransport(), peer_id="sched", bootstrap=boot)
    started: list = []
    stalls: list = []
    side: dict = {}
    side_tasks: list = []
    peak, stop_sampler = [0.0], asyncio.Event()
    sampler = asyncio.create_task(_device_mem_sampler(peak, stop_sampler)) if sample_card else None
    watch = asyncio.create_task(watch_loop(stalls))
    with node_probes(device) as rec, (reducer_probes(rec) if check_reducer
                                      else nullcontext()):
        try:
            for part in (data, *trainers, *pss, node):
                await part.start(listen)
                started.append(part)
            await node.wait_for_bootstrap()
            side.update(rec=rec, data=data, started=started, boot=boot, root=root,
                        data_dir=data_dir)
            side_tasks += [asyncio.create_task(fn(side)) for fn in alongside]
            result = await Orchestrator(node).run(job, status_timeout=status_timeout)
            # The jobs end after the scheduler's last answer: wait for each
            # job's final status (the recorder that replaced the router).
            final = {"completed", "failed", "cancelled"}
            loop = asyncio.get_running_loop()
            deadline = loop.time() + limit_s
            job_ids = {d["job_id"] for d in rec["dispatch"]}
            while True:
                ended = {s["job_id"] for s in rec["statuses"] if s["state"] in final}
                finished = job_ids <= ended
                if finished or loop.time() > deadline:
                    break
                await asyncio.sleep(0.1)
        finally:
            # The side tasks end on ``done`` (a restart under way finishes);
            # whatever still runs after 30 s is cancelled.
            side["done"] = True
            if side_tasks:
                await asyncio.wait(side_tasks, timeout=30)
            watch.cancel()
            stop_sampler.set()
            if sampler is not None:
                await sampler
            for task in side_tasks:
                task.cancel()
            side_errors = [repr(e) for e in await asyncio.gather(*side_tasks,
                                                                   return_exceptions=True)
                           if isinstance(e, Exception) and not isinstance(e, asyncio.CancelledError)]
            for part in reversed(started):
                await part.stop()
            await gw.stop()
    # The parameter server clears its work dir in a thread as its job ends.
    leftover: list = []
    for _ in range(300):
        leftover = sorted(str(p.relative_to(root)) for p in root.rglob("*")
                          if p.is_file() and not p.is_relative_to(data_dir)
                          and "slice-cache" not in p.relative_to(root).parts)
        if not leftover:
            break
        await asyncio.sleep(0.1)
    train = [d for d in rec["dispatch"] if d["kind"] == "train"]
    agg = [d for d in rec["dispatch"] if d["kind"] == "aggregate"]
    jobs = {d["peer"] if d["kind"] == "train" else
            ("aggregate" if len(agg) == 1 else f"aggregate@{d['peer']}"):
            [s["state"] for s in rec["statuses"] if s["job_id"] == d["job_id"]]
            for d in rec["dispatch"]}
    beats = [p["t"] for p in rec["progress"] if p["kind"] == "status"]
    return dict(job=job, result=result, rec=rec, finished=finished,
                workers=[d["peer"] for d in train], ps=agg[0]["peer"] if agg else None,
                ps_peers=[d["peer"] for d in agg], card_peak_mib=peak[0] if sample_card else None,
                jobs=jobs,
                auction_to_dispatch_s=max(d["t"] for d in rec["dispatch"]) - rec["auctions"][0]["t0"],
                first_beat_s=(min(beats) - max(d["t"] for d in train)) if beats else None,
                loop_stall_max_s=max(stalls, default=0.0),
                loop_stalls_over_1s=sum(s > 1.0 for s in stalls), leftover=leftover,
                side={**side, "errors": side_errors})


async def watch_loop(stalls: list, tick: float = 0.05) -> None:
    """Append how late each ``tick`` s sleep of this event loop woke: the
    nodes share the loop, and a stall past a third of the 10 s lease lets
    a lease expire before the scheduler's renewal lands."""
    loop = asyncio.get_running_loop()
    while True:
        t0 = loop.time()
        await asyncio.sleep(tick)
        stalls.append(loop.time() - t0 - tick)


def progress_timing(run: dict) -> dict:
    """The scheduler's view of the job, from ``node_probes``' stamps: step
    ms (the median interval between a worker's consecutive ``STATUS`` in
    one round), each worker's round boundary s (``UPDATE`` to
    ``UPDATE_RECEIVED``), every gap over 5 s between two progress messages
    and the largest (the watchdog resets on each) beside the least deadline
    the watchdog held and the least adaptive one it computed inside it, and
    the batch scheduler's handling ms per message."""
    prog = run["rec"]["progress"]
    steps, boundary = [], []
    for peer in run["workers"]:
        mine = [p for p in prog if p["peer"] == peer]
        beats = [p for p in mine if p["kind"] == "status"]
        steps += [(b["t"] - a["t"]) * 1e3 for a, b in zip(beats, beats[1:])
                  if a["round"] == b["round"]]
        t_update = {p["round"]: p["t"] for p in mine if p["kind"] == "update"}
        boundary += [{"peer": peer, "round": p["round"], "s": p["t"] - t_update[p["round"]]}
                     for p in mine if p["kind"] == "update-received" and p["round"] in t_update]
    pairs = list(zip(prog, prog[1:]))
    gap = max(pairs, key=lambda ab: ab[1]["t"] - ab[0]["t"], default=None)
    timeouts = run["rec"]["timeouts"]
    inside = [(v, a) for t, v, a in timeouts if gap and gap[0]["t"] <= t <= gap[1]["t"]]
    ms = [p["ms"] for p in prog]
    return dict(
        step_ms=statistics.median(steps) if steps else None, step_ms_all=steps,
        round_boundary_s=boundary,
        progress_gap_max_s=(gap[1]["t"] - gap[0]["t"]) if gap else None,
        progress_gap_between=[(p["peer"], p["kind"], p["round"]) for p in gap] if gap else None,
        progress_gaps_over_5s=[(a["kind"], b["kind"], b["round"], b["t"] - a["t"])
                               for a, b in pairs if b["t"] - a["t"] > 5.0],
        watchdog_timeout_in_gap_s=min((v for v, _ in inside), default=None),
        adaptive_deadline_in_gap_s=min((a for _, a in inside), default=None),
        watchdog_timeouts_s=sorted({v for _, v, _ in timeouts}),
        adaptive_deadlines_s=sorted({a for _, _, a in timeouts}),
        handling_ms_median=statistics.median(ms) if ms else None,
        handling_ms_max=max(ms, default=None), progress_messages=len(ms),
    )


def node_problems(run: dict, *, rounds: int, expect: dict) -> list:
    """The gates the port must pass under its own scheduler, on the CPU as
    on the card: every job ``running`` then ``completed`` (each trainer
    exited 0 in time), ``JobResult.rounds``, each round's ``STATUS``
    heartbeats times their batch sizes summing to the job's
    ``avg_samples_between_updates`` (with several workers, within the
    projection's reach), the dispatched train specs' batch
    size, the train jobs on the ``w`` nodes and the aggregate job on
    ``psw``, the parameter server's UPDATED for each round, each worker's
    finite round losses (``JobResult.metrics``) with the last below the
    first, each Δθ the server received in the config's flat f32 names and
    shapes (an HQD1 frame: the names and shapes, in the job's codec), no
    failed lease renewal and no file left behind."""
    rec, job, result = run["rec"], run["job"], run["result"]
    problems = []
    if not run["finished"] or any(s != ["running", "completed"] for s in run["jobs"].values()):
        problems.append(f"job states {run['jobs']} (a trainer must exit 0 in time)")
    if result.rounds != rounds:
        problems.append(f"JobResult.rounds {result.rounds}, wanted {rounds}")
    # One worker's countdown lands on the target exactly. With several,
    # the reference's batch scheduler plans each worker's share from its
    # projection (a worker already counting down is projected again from
    # scratch), so a round can end a few batches off it: within the
    # projection's cap of batches of every worker.
    from hypha_tpu_torch.scheduler.batch_scheduler import UPDATES_CAP

    target = job.rounds.avg_samples_between_updates
    slack = 0 if job.resources.num_workers == 1 else \
        UPDATES_CAP * job.rounds.max_batch_size * job.resources.num_workers
    samples = [sum(p["batch_size"] for p in rec["progress"]
                   if p["kind"] == "status" and p["round"] == r) for r in range(rounds)]
    if any(abs(n - target) > slack for n in samples):
        problems.append(f"samples a round {samples}, wanted {target} each (within {slack})")
    batches = [d["batch_size"] for d in rec["dispatch"] if d["kind"] == "train"]
    if batches != [job.rounds.max_batch_size] * job.resources.num_workers:
        problems.append(f"dispatched batch sizes {batches}, wanted {job.rounds.max_batch_size}")
    want = [f"w{i}" for i in range(job.resources.num_workers)]
    if sorted(run["workers"]) != want or run["ps"] != "psw":
        problems.append(f"train jobs on {run['workers']} and the aggregate job on {run['ps']}, "
                        f"wanted {want} and psw")
    updated = [p["round"] for p in rec["progress"] if p["kind"] == "updated"]
    if updated != list(range(rounds)):
        problems.append(f"the parameter server's UPDATED rounds {updated}")
    for peer in run["workers"]:
        losses = [m.get("loss") for w, _, m in result.metrics if w == peer]
        if (len(losses) != rounds or None in losses
                or not torch.isfinite(torch.tensor(losses, dtype=torch.float64)).all()
                or not losses[-1] < losses[0]):
            problems.append(f"{peer}: round losses {losses}: not finite, or the last not below "
                            "the first")
    shapes = {k: shape for k, (_, shape) in expect.items()}
    bad = [i for i, d in enumerate(rec["deltas"])
           if (d["tensors"] != expect if d["frame"] is None else
               (d["frame"]["codec"], d["frame"]["tensors"]) != (job.delta_codec, shapes))]
    if len(rec["deltas"]) != rounds * len(run["workers"]) or bad:
        problems.append(f"Δθ files {bad} of {len(rec['deltas'])} differ from the config's flat "
                        f"names and shapes (f32, or the job's {job.delta_codec} frames)")
    if rec["renew_failures"]:
        problems.append(f"lease renewals failed: {rec['renew_failures']}")
    if run["leftover"]:
        problems.append(f"files left behind: {run['leftover']}")
    return problems


# train_node runs the train job at NODE_LAYERS: its gates are the network's
# and the scheduler's, and ``train`` measures the 8-layer step. 1 layer
# since train_swap joined the smoke (2 before it, 4 before train_shard_ft),
# for the smoke's time limit.
NODE_LAYERS = 1
NODE_MODEL = {**TRAIN_MODEL, "config": {**TRAIN_MODEL["config"], "num_layers": NODE_LAYERS}}


def train_node_phase(train: dict) -> dict:
    """The ``train`` phase's job, cut to ``NODE_LAYERS`` layers, run by the
    port's own nodes under the port's scheduler: auction, dispatch, slice
    assignment and pulls from the data node, the batch scheduler's
    countdown, Δθ and the update over push streams, the parameter server's
    fold and Nesterov step on the card."""
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-node-"))
    try:
        run = asyncio.run(run_node_job(root, NODE_MODEL, device="cuda", rounds=TRAIN_ROUNDS,
                                       steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                       period=TRAIN_PERIOD, status_timeout=NODE_STATUS_TIMEOUT_S))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec, result = run["rec"], run["result"]
    log = "\n".join(rec["log"])
    timing = progress_timing(run)
    step_ms = timing["step_ms"]
    found = re.search(r"attention launches: (\{.*\})", log)
    launches = json.loads(found.group(1)) if found else None
    peak = re.search(r"peak device memory: ([\d.]+) GiB", log)
    heartbeats = [p for p in rec["progress"] if p["kind"] == "status"]

    def rates(xs):
        return [x["bytes"] / x["s"] / 1e6 for x in xs]

    def trainer_s(what):
        return [float(x) for x in re.findall(rf"round \d+: {what} in ([\d.]+) s", log)]

    res = dict(
        model="llama2-7b", layers=NODE_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
        scheduler="hypha_tpu_torch.scheduler.orchestrator.Orchestrator",
        status_timeout_s=NODE_STATUS_TIMEOUT_S,
        adaptive_margin_s=(timing["adaptive_deadline_in_gap_s"] - timing["progress_gap_max_s"]
                           if timing["adaptive_deadline_in_gap_s"] is not None else None),
        workers={"train": run["workers"], "parameter_server": run["ps"]},
        dispatched_batch=[d["batch_size"] for d in rec["dispatch"] if d["kind"] == "train"],
        jobs=run["jobs"], result_rounds=result.rounds, heartbeats=len(heartbeats),
        batches_a_round=[sum(p["round"] == r for p in heartbeats) for r in range(TRAIN_ROUNDS)],
        schedule_updates=[(p["peer"], p["round"], p["counter"]) for p in rec["progress"]
                          if p["answer"] == "schedule-update"],
        updated=[p["round"] for p in rec["progress"] if p["kind"] == "updated"],
        losses=[(w, r, m.get("loss")) for w, r, m in result.metrics],
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3) if step_ms else None,
        **timing,
        delta_push=rec["push"], delta_push_mb_per_s=rates(rec["push"]),
        delta_received=[{k: d[k] for k in ("round", "from", "s", "bytes")} for d in rec["deltas"]],
        broadcast=rec["broadcast"], broadcast_mb_per_s=rates(rec["broadcast"]),
        fold_s=rec["fold_s"], outer_step_s=rec["outer_step_s"],
        trainer_delta_write_s=trainer_s("delta written"),
        trainer_update_merge_s=trainer_s("update merged"),
        auctions=[{"executor": a["executor"], "s": a["t1"] - a["t0"], "offers": a["offers"]}
                  for a in rec["auctions"]],
        auction_to_dispatch_s=run["auction_to_dispatch_s"],
        loop_stall_max_s=run["loop_stall_max_s"], loop_stalls_over_1s=run["loop_stalls_over_1s"],
        dispatch_to_first_heartbeat_s=run["first_beat_s"], attention_launches=launches,
        trainer_peak_gib=float(peak.group(1)) if peak else None,
        slices_assigned=len(rec["slices"]), leftover_files=run["leftover"],
        train_phase={k: train[k] for k in ("step_ms", "tokens_per_s", "update_phase_s", "peak_mem_gib")},
        seconds=time.perf_counter() - t0,
    )
    steps_total = sum(res["batches_a_round"])
    want = {"fwd": 2 * NODE_LAYERS * steps_total, "dq": NODE_LAYERS * steps_total,
            "dkv": NODE_LAYERS * steps_total, "flash_plain": 0, "dense": 0}
    problems = node_problems(run, rounds=TRAIN_ROUNDS, expect=flat_f32_spec(NODE_MODEL))
    if res["batches_a_round"] != [TRAIN_STEPS] * TRAIN_ROUNDS:
        problems.append(f"batches a round {res['batches_a_round']}, wanted {TRAIN_STEPS} each")
    if "attention path: flash kernels" not in log or launches != want:
        problems.append(f"attention launches {launches}, wanted {want} through the flash kernels")
    if problems:
        emit({"phase": "train_node", **res, "problems": problems, "worker_log_tail": log[-4000:]})
        raise SystemExit("train_node phase failed: " + "; ".join(problems))
    return res


# ---------------------------------------------------------- train_data phase

# The input pipeline's phase (``train_data_phase``): NODE_MODEL at [2, 2048]
# in slices of DATA_SAMPLES samples (2 batches each), prefetched
# DATA_PREFETCH deep, int8 deltas (a quarter of the f32 round boundary).
DATA_SAMPLES = 4
DATA_PREFETCH = 2
DATA_A_ROUNDS, DATA_A_STEPS = 2, 3  # part (a): the local session
DATA_B_ROUNDS, DATA_B_STEPS = 3, 4  # part (b): the network, two trainers
DATA_RESTART_S = 1.0  # the data node's outage
# Part (b)'s dataset: 18 slices, 72 samples for the job's 48. By round 1's
# first delta each trainer has taken at most 4 slices and holds 3 more, so
# at least 4 of the first epoch are still to be pulled from the data node
# (the kill needs a network pull), and the job's ~24 assignments wrap the
# epoch, whose slices the caches then serve.
DATA_B_SLICES = 18
DATA_OPTIONS = {"delta_codec": "int8", "input_pipeline": True, "prefetch_slices": DATA_PREFETCH}
_TRAINING_DONE = re.compile(r"training done: (\d+) rounds, (\d+) batches, ([\d.]+)s")
_DATA_METRICS = re.compile(r"data metrics: (\{.*\})")
_LAUNCHES = re.compile(r"attention launches: (\{.*\})")


class DataSession(Scheduler):
    """A local session for ``run_training``: the ``Scheduler``'s rounds,
    each fetch a copy of the next of ``slices`` under the job's
    ``artifacts`` (as the connector writes a pulled slice; the pipeline
    deletes what it read), and each round's update the trainer's own Δθ
    file handed back (θ ← θ_t + Δθ: no server work, the same in every run)."""

    def __init__(self, work_dir: Path, slices: list, *, rounds: int, steps: int):
        super().__init__(rounds=rounds, steps=steps)
        self.dir, self.slices = Path(work_dir), slices
        self.fetches = 0
        self.lock = threading.Lock()
        self.events: "queue.Queue[dict]" = queue.Queue()
        (self.dir / "artifacts").mkdir(parents=True, exist_ok=True)

    def fetch(self, ref):
        with self.lock:
            i = self.fetches
            self.fetches += 1
        dest = self.dir / "artifacts" / f"slice-{i:06d}"
        shutil.copyfile(self.slices[i % len(self.slices)], dest)
        return [f"artifacts/{dest.name}"]

    def send_status(self, progress):
        with self.lock:
            return self.answer(progress)

    def send_resource(self, send, path, resource="updates", meta=None):
        self.events.put({"path": path, "meta": {"round": meta["round"]}})

    @contextmanager
    def receive(self, ref):
        def gen():
            while True:
                try:
                    yield self.events.get(timeout=600)
                except queue.Empty:
                    return

        yield gen()


def steady_step_ms(session: Scheduler) -> "float | None":
    """The median STATUS interval inside a round but the round's first.
    With the loss read deferred, a STATUS follows its step's dispatch, so
    each interval holds the previous step's device time: the first of a
    round holds the round's first step, which regrows the allocator after
    the boundary's ``empty_cache``; synchronously it holds the second."""
    out = []
    for r in sorted({r for r, _ in session.marks}):
        ts = [t for rr, t in session.marks if rr == r]
        out += [(b - a) * 1e3 for a, b in zip(ts[1:], ts[2:])]
    return statistics.median(out) if out else None


def data_local_runs(model: dict, *, device, rounds, steps, batch, seq, period) -> dict:
    """Part (a): one job through ``run_training`` twice over one set of
    slices (``DATA_SAMPLES`` each, enough for the job), with the input
    pipeline off and then on (``DATA_OPTIONS``), each behind its own
    ``DataSession``: each run's losses, flash launches (counted from 0
    before it), ``DATA_METRICS`` snapshot, step ms and seconds."""
    import hypha_tpu_torch.executor.training as training
    from hypha_tpu_torch.ops.attention import dot_product_attention
    from hypha_tpu_torch.ops.flash_attention import flash_attention
    from hypha_tpu_torch.telemetry.ft_metrics import DATA_METRICS

    work = Path(tempfile.mkdtemp(prefix="chip-smoke-data-"))
    runs = {}
    try:
        src = work / "slices"
        src.mkdir()
        slices = write_slices(src, n_slices=rounds * steps * batch // DATA_SAMPLES,
                              per_slice=DATA_SAMPLES, seq=seq, period=period, seed=7)
        for name, options in (("sync", {"delta_codec": "int8"}), ("pipelined", DATA_OPTIONS)):
            session = DataSession(work / name, slices, rounds=rounds, steps=steps)
            spec = train_spec(f"chip-smoke-data-{name}", model, batch=batch, lr=3e-4, **options)
            DATA_METRICS.reset()
            flash_attention.fwd_launches = flash_attention.dq_launches = 0
            flash_attention.dkv_launches = flash_attention.plain_calls = 0
            dot_product_attention.calls = 0
            t0 = time.perf_counter()
            result = training.run_training(session, work / name, spec, device=device)
            _sync(torch.device(device))
            runs[name] = dict(
                losses=result.losses, rounds=result.rounds, batches=result.batches,
                launches={"fwd": flash_attention.fwd_launches, "dq": flash_attention.dq_launches,
                          "dkv": flash_attention.dkv_launches,
                          "flash_plain": flash_attention.plain_calls,
                          "dense": dot_product_attention.calls},
                data_metrics=DATA_METRICS.snapshot(), step_ms=session.step_ms(),
                steady_step_ms=steady_step_ms(session),
                fetches=session.fetches,
                slice_files_left=len(list((work / name / "artifacts").iterdir())),
                seconds=time.perf_counter() - t0)
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return runs


def data_local_problems(runs: dict, *, rounds: int, steps: int, layers: int,
                        device: str) -> list:
    """Part (a)'s gates: the two runs' losses equal float for float (finite,
    ``rounds`` x ``steps`` of them) and their flash launches equal, the
    path's (on the card: 2 x ``layers`` / ``layers`` / ``layers`` a step,
    remat, and no plain attention; on the CPU the plain attention)."""
    sync, piped = runs["sync"], runs["pipelined"]
    problems = []
    n = rounds * steps
    if piped["losses"] != sync["losses"] or len(sync["losses"]) != n \
            or not all(math.isfinite(x) for x in sync["losses"]):
        problems.append(f"(a) losses: sync {sync['losses']}, pipelined {piped['losses']} "
                        f"(wanted {n} equal float for float)")
    if not (piped["rounds"], piped["batches"]) == (sync["rounds"], sync["batches"]) == (rounds, n):
        problems.append(f"(a) rounds and batches {sync['rounds'], sync['batches']} / "
                        f"{piped['rounds'], piped['batches']}")
    want = ({"fwd": 2 * layers * n, "dq": layers * n, "dkv": layers * n, "flash_plain": 0,
             "dense": 0} if device == "cuda" else None)
    if piped["launches"] != sync["launches"] or (want and sync["launches"] != want):
        problems.append(f"(a) flash launches: sync {sync['launches']}, pipelined "
                        f"{piped['launches']} (wanted equal{f', {want}' if want else ''})")
    return problems


def data_chaos(restart_s: float = DATA_RESTART_S):
    """A ``run_node_job`` side task: once round 1's first delta landed, the
    data node dies as the next network pull of a slice starts (its
    listener closes before the pull dials it, then the node stops; a pull
    the slice cache serves moves no bytes and does not count), and a new
    data node starts under the same peer id and port ``restart_s`` later,
    also when the job ended meanwhile."""
    async def chaos(side: dict) -> None:
        from hypha_tpu_torch.data_node import DataNode
        from hypha_tpu_torch.network import Node, TcpTransport

        rec, old = side["rec"], side["data"]
        fired = asyncio.Event()
        pull = Node.pull

        async def killing_pull(self, peer_id, resource):
            if peer_id == old.peer_id and not fired.is_set() and side.get("armed"):
                for server in old.node.transport._servers:
                    server.close()
                side["kill"] = {"t": time.perf_counter(), "puller": self.peer_id,
                                "index": getattr(resource, "index", None),
                                "addr": old.node.listen_addrs[0]}
                fired.set()
            return await pull(self, peer_id, resource)

        Node.pull = killing_pull
        try:
            while not any(d["round"] == 1 for d in rec["deltas"]):
                if side.get("done"):
                    return
                await asyncio.sleep(0.02)
            side["armed"] = time.perf_counter()
            while not fired.is_set():
                if side.get("done"):
                    return
                await asyncio.sleep(0.02)
        finally:
            Node.pull = pull
        await old.stop()
        side["started"].remove(old)
        await asyncio.sleep(restart_s)
        new = DataNode(TcpTransport(), {NODE_DATASET: side["data_dir"]}, peer_id="data",
                       bootstrap=side["boot"])
        await new.start([old.node.listen_addrs[0]])
        side["started"].append(new)
        side["restart_t"] = time.perf_counter()
        side["restart_addr"] = new.node.listen_addrs[0]
    return chaos


async def slice_files_watch(side: dict) -> None:
    """A ``run_node_job`` side task: the most slice files each trainer's
    job directory held at once (sampled every 50 ms until ``done``)."""
    peak = side.setdefault("slice_files_peak", {})
    while not side.get("done"):
        for d in side["root"].glob("w*/hypha-*/artifacts"):
            try:
                n = sum(1 for p in d.iterdir() if p.is_file())
            except OSError:
                continue
            key = str(d.parent.relative_to(side["root"]))
            peak[key] = max(peak.get(key, 0), n)
        await asyncio.sleep(0.05)


async def run_data_job(root: Path, model: dict, *, device, rounds, steps, batch, seq, period,
                       workers=2, n_slices=DATA_B_SLICES, restart_s=DATA_RESTART_S,
                       status_timeout=None) -> dict:
    """Part (b): ``run_node_job`` with ``DATA_OPTIONS``, ``workers``
    trainer processes, ``n_slices`` slices of ``DATA_SAMPLES``, the slice caches on (the
    worker nodes', under ``w*/slice-cache``), ``data_chaos`` and
    ``slice_files_watch`` beside it. Each trainer is a process of its own,
    so its ``data metrics`` line is its own; the connectors run in this
    process, whose ``DATA_METRICS`` (reset here) counts both nodes' pulled
    bytes and cache outcomes. Returns the run with ``node_data_metrics``
    and each cache's entries, bytes and bound under ``caches``."""
    from hypha_tpu_torch.telemetry.ft_metrics import DATA_METRICS
    from hypha_tpu_torch.worker.slice_cache import SliceCache

    DATA_METRICS.reset()
    run = await run_node_job(root, model, device=device, rounds=rounds, steps=steps, batch=batch,
                             seq=seq, period=period, workers=workers, per_slice=DATA_SAMPLES,
                             n_slices=n_slices, status_timeout=status_timeout,
                             job_options=DATA_OPTIONS,
                             alongside=(data_chaos(restart_s), slice_files_watch))
    caches = {}
    for i in range(workers):
        cache = SliceCache(root / f"w{i}" / "slice-cache")
        caches[f"w{i}"] = {"entries": cache.entries() if cache.root.exists() else 0,
                           "bytes": cache.bytes_used() if cache.root.exists() else 0,
                           "max_bytes": cache.max_bytes}
    return {**run, "node_data_metrics": DATA_METRICS.snapshot(), "caches": caches}


def data_report(run: dict) -> dict:
    """Part (b)'s figures: each trainer's ``data metrics`` line with its
    input-wait fraction of the loop's seconds, step ms (the scheduler's
    stamps), flash launches; the nodes' pulled bytes and cache outcomes;
    kill to restart; the held windows and epochs of every assignment."""
    logs = trainer_logs(run)
    prog = run["rec"]["progress"]
    per = {}
    for peer, lines in logs.items():
        text = "\n".join(lines)
        metrics = _DATA_METRICS.search(text)
        done = _TRAINING_DONE.search(text)
        launches = _LAUNCHES.search(text)
        snap = json.loads(metrics.group(1)) if metrics else None
        loop_s = float(done.group(3)) if done else None
        beats = [p for p in prog if p["kind"] == "status" and p["peer"] == peer]
        steps = [(b["t"] - a["t"]) * 1e3 for a, b in zip(beats, beats[1:])
                 if a["round"] == b["round"]]
        per[peer] = dict(
            data_metrics=snap, loop_s=loop_s,
            input_wait_fraction=(snap["input_wait_seconds"] / loop_s
                                 if snap and loop_s else None),
            batches=len(beats), step_ms=statistics.median(steps) if steps else None,
            launches=json.loads(launches.group(1)) if launches else None)
    side = run["side"]
    kill = side.get("kill")
    assigned = run["rec"]["assigned"]
    return dict(
        trainers=per, node_data_metrics=run["node_data_metrics"], caches=run["caches"],
        kill=kill, kill_to_restart_s=(side["restart_t"] - kill["t"])
        if kill and "restart_t" in side else None,
        slice_files_peak=side.get("slice_files_peak", {}), side_errors=side.get("errors"),
        assignments=len(assigned), held_max=max((a["held"] for a in assigned), default=0),
        epochs=sorted({a["epoch"] for a in assigned}), attempt=run["result"].attempt)


def data_problems(run: dict, rep: dict, *, rounds: int, layers: int, device: str) -> list:
    """Part (b)'s gates: ``node_problems`` (both jobs completed, every
    round ``UPDATED``, falling losses, int8 frames of the config's names,
    no failed renewal, no file left but the caches), ``attempt`` 0, the
    kill fired and the node restarted under its port, a trainer's
    ``prefetch_errors`` >= 1, no held window over ``DATA_PREFETCH``, every
    epoch that wrapped served every slice first, at most ``DATA_PREFETCH``
    + 2 slice files in a job directory at once, each cache within its
    bound, and each trainer's flash launches its batches' (on the card; on
    the CPU the plain attention)."""
    problems = node_problems(run, rounds=rounds, expect=flat_f32_spec(run["job"].model))
    if rep["attempt"] != 0:
        problems.append(f"(b) attempt {rep['attempt']}: wanted 0 (no full restart)")
    if rep["kill"] is None or rep["kill_to_restart_s"] is None:
        problems.append(f"(b) the data node was not killed and restarted: {rep['kill']}")
    elif run["side"].get("restart_addr") != rep["kill"]["addr"]:
        problems.append(f"(b) restarted on {run['side'].get('restart_addr')}, killed on "
                        f"{rep['kill']['addr']}")
    if rep["side_errors"]:
        problems.append(f"(b) side tasks failed: {rep['side_errors']}")
    errors = {p: (t["data_metrics"] or {}).get("prefetch_errors") for p, t in rep["trainers"].items()}
    if not any((e or 0) >= 1 for e in errors.values()):
        problems.append(f"(b) no trainer's prefetch failed across the kill: {errors}")
    if rep["held_max"] > DATA_PREFETCH:
        problems.append(f"(b) a worker held {rep['held_max']} slices (window {DATA_PREFETCH})")
    assigned = run["rec"]["assigned"]
    n = assigned[0]["num_slices"] if assigned else 0
    for epoch in rep["epochs"][:-1]:
        served = {a["index"] for a in assigned if a["epoch"] == epoch}
        if served != set(range(n)):
            problems.append(f"(b) epoch {epoch} wrapped after serving {sorted(served)} of {n}")
    over = {d: k for d, k in rep["slice_files_peak"].items() if k > DATA_PREFETCH + 2}
    if over or not rep["slice_files_peak"]:
        problems.append(f"(b) slice files in a job directory at once: {rep['slice_files_peak']}")
    for peer, c in rep["caches"].items():
        if c["bytes"] > c["max_bytes"]:
            problems.append(f"(b) {peer}'s slice cache holds {c['bytes']} of {c['max_bytes']}")
    for peer, t in rep["trainers"].items():
        n_b = t["batches"]
        want = ({"fwd": 2 * layers * n_b, "dq": layers * n_b, "dkv": layers * n_b,
                 "flash_plain": 0, "dense": 0} if device == "cuda" else
                {"fwd": 0, "dq": 0, "dkv": 0, "flash_plain": 0})
        got = t["launches"] if device == "cuda" else \
            {k: v for k, v in (t["launches"] or {}).items() if k != "dense"}
        if got != want or t["data_metrics"] is None:
            problems.append(f"(b) {peer}: attention launches {t['launches']} for {n_b} batches "
                            f"(wanted {want}); data metrics {t['data_metrics']}")
    return problems


def train_data_phase() -> dict:
    """The input pipeline on the card (``NODE_MODEL``: 7B widths at 1
    layer, [2, 2048], remat, through the flash kernels): (a) the same job
    through ``run_training`` with the pipeline off and on (``DATA_A_ROUNDS``
    of ``DATA_A_STEPS``), the losses and flash launches equal; (b) the
    port's nodes with two trainer processes, the pipeline and the slice
    caches on, ``DATA_B_ROUNDS`` of ``DATA_B_STEPS``, the data node killed
    mid-prefetch and restarted (``data_chaos``). Reports each trainer's
    input waits, the boundary stall, the queue's peak, the slices and bytes
    fetched, the caches' hits and misses, step ms and kill to restart, and
    part (a)'s sync snapshot: the stall the pipeline hides."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    local = data_local_runs(NODE_MODEL, device="cuda", rounds=DATA_A_ROUNDS, steps=DATA_A_STEPS,
                            batch=TRAIN_BATCH, seq=TRAIN_SEQ, period=TRAIN_PERIOD)
    problems = data_local_problems(local, rounds=DATA_A_ROUNDS, steps=DATA_A_STEPS,
                                   layers=NODE_LAYERS, device="cuda")
    t_b = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="hda"))
    tdir = None
    try:
        with traced_phase("train_data") as tdir:
            run = asyncio.run(run_data_job(root, NODE_MODEL, device="cuda", rounds=DATA_B_ROUNDS,
                                           steps=DATA_B_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                           period=TRAIN_PERIOD,
                                           status_timeout=NODE_STATUS_TIMEOUT_S))
        rep = data_report(run)
        problems += data_problems(run, rep, rounds=DATA_B_ROUNDS, layers=NODE_LAYERS,
                                  device="cuda")
        tproblems, waits = data_trace_problems(tdir, rep)
        problems += [f"(b) trace: {x}" for x in tproblems]
        tsum = trace_summary(tdir, "train_data")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if tdir is not None:
            shutil.rmtree(tdir, ignore_errors=True)
    timing = progress_timing(run)
    res = dict(
        model="llama2-7b", layers=NODE_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
        slice_samples=DATA_SAMPLES, prefetch_slices=DATA_PREFETCH,
        local={name: {k: r[k] for k in ("losses", "launches", "data_metrics", "step_ms",
                                        "steady_step_ms", "fetches", "slice_files_left",
                                        "seconds")}
               for name, r in local.items()},
        stall_the_pipeline_hides=local["sync"]["data_metrics"],
        network={**rep, "jobs": run["jobs"],
                 "losses": [(w, r, m.get("loss")) for w, r, m in run["result"].metrics],
                 "round_boundary_s": timing["round_boundary_s"], "step_ms": timing["step_ms"],
                 "seconds": time.perf_counter() - t_b,
                 "trace": {"input_waits": waits,
                           **{k: v for k, v in tsum.items() if k != "timeline"},
                           "rounds": [{k: row[k] for k in ("round", "wall_s", "phases_s",
                                                           "stall_span", "stall_peer")}
                                      for row in tsum["timeline"]["rounds"]]}},
        seconds=time.perf_counter() - t0)
    if problems:
        emit({"phase": "train_data", **res, "problems": problems,
              "worker_log_tail": "\n".join(run["rec"]["log"])[-4000:]})
        raise SystemExit("train_data phase failed: " + "; ".join(problems))
    return res


STREAM_OPTIONS = {"delta_codec": "int8", "sync_mode": "stream", "num_fragments": 4}
STREAM_ROUNDS, STREAM_STEPS = 4, 8  # every fragment syncs once
# train_stream and train_secure (which compares its TLS transfers with
# train_stream's in the same run) run NODE_MODEL's layers for the smoke's
# time limit; the 8-layer step is train's.


def trainer_log(log: str) -> dict:
    """What the trainer process logged (through the worker's log): its
    launches, peak, batches, each flight's encode, landing and merge, and
    its step seconds with and without a flight out."""
    found = re.search(r"attention launches: (\{.*\})", log)
    peak = re.search(r"peak device memory: ([\d.]+) GiB", log)
    done = re.search(r"training done: (\d+) rounds, (\d+) batches", log)
    steps = re.search(r"step seconds: (\{.*\})", log)
    flights: dict = {}
    for r, f, s, n in re.findall(r"round (\d+) fragment (\d+): delta encoded in ([\d.]+) s "
                                 r"\((\d+) bytes\)", log):
        flights.setdefault(int(r), {}).update(fragment=int(f), encode_s=float(s), bytes=int(n))
    for r, _f, s in re.findall(r"round (\d+) fragment (\d+): broadcast landed ([\d.]+) s", log):
        flights.setdefault(int(r), {})["flight_s"] = float(s)
    for r, _f, m, w, n in re.findall(r"round (\d+) fragment (\d+): update merged in ([\d.]+) s; "
                                     r"waited ([\d.]+) s for the flight; (\d+) steps in flight", log):
        flights.setdefault(int(r), {}).update(merge_s=float(m), finish_wait_s=float(w),
                                              steps_in_flight=int(n))
    return dict(launches=json.loads(found.group(1)) if found else None,
                peak_gib=float(peak.group(1)) if peak else None,
                batches=int(done.group(2)) if done else None,
                step_s=json.loads(steps.group(1)) if steps else None, flights=flights)


def stream_problems(run: dict, *, rounds: int, fragments: int, expect: dict, codec: str) -> list:
    """The gates of a stream job under the port's scheduler, on the CPU as
    on the card: both jobs ``running`` then ``completed``, the rounds,
    ``UPDATED`` each round, finite falling round losses, one frame a round
    from each worker, each an HQD1 ``codec`` frame tagged (round, due
    fragment, ``fragments``) as its push header is and holding exactly the
    due fragment of ``partition_names`` over the config's flat names with
    their shapes, each fragment synced (with ``rounds == fragments``, once),
    a tagged broadcast a round, no failed renewal and no file left
    behind."""
    from hypha_tpu_torch.stream import partition_names

    rec, result = run["rec"], run["result"]
    problems = []
    if not run["finished"] or any(s != ["running", "completed"] for s in run["jobs"].values()):
        problems.append(f"job states {run['jobs']} (a trainer must exit 0 in time)")
    if result.rounds != rounds:
        problems.append(f"JobResult.rounds {result.rounds}, wanted {rounds}")
    updated = [p["round"] for p in rec["progress"] if p["kind"] == "updated"]
    if updated != list(range(rounds)):
        problems.append(f"the parameter server's UPDATED rounds {updated}")
    for peer in run["workers"]:
        losses = [m.get("loss") for w, _, m in result.metrics if w == peer]
        if (len(losses) != rounds or None in losses
                or not torch.isfinite(torch.tensor(losses, dtype=torch.float64)).all()
                or not losses[-1] < losses[0]):
            problems.append(f"{peer}: round losses {losses}: not finite, or the last not below "
                            "the first")
    parts = partition_names({n: math.prod(s) for n, (_, s) in expect.items()}, fragments)
    synced: list = []
    if len(rec["deltas"]) != rounds * len(run["workers"]):
        problems.append(f"{len(rec['deltas'])} deltas received, wanted {rounds} a worker")
    for d in rec["deltas"]:
        r, frame = d["round"], d["frame"]
        tag = {"round": r, "fragment_id": r % fragments, "fragments": fragments}
        head = {k: d["header"].get(k) for k in tag}
        if frame is None or frame["codec"] != codec or frame["tag"] != tag or head != tag:
            problems.append(f"round {r} from {d['from']}: frame {frame and frame['codec']} "
                            f"tagged {frame and frame['tag']}, header {head}; wanted a {codec} "
                            f"frame tagged {tag}")
            continue
        want = {n: expect[n][1] for n in parts[r % fragments]}
        if frame["tensors"] != want:
            problems.append(f"round {r}: the frame holds {sorted(frame['tensors'])}, not "
                            f"fragment {r % fragments} of the partition")
        synced.append(r % fragments)
    if sorted(set(synced)) != list(range(min(rounds, fragments))):
        problems.append(f"fragments synced {sorted(set(synced))}")
    heads = [b["header"] for b in sorted(rec["broadcast"], key=lambda b: b["round"])]
    if heads != [{"round": r, "fragment_id": r % fragments, "fragments": fragments}
                 for r in range(rounds)]:
        problems.append(f"broadcast headers {heads}")
    if rec["renew_failures"]:
        problems.append(f"lease renewals failed: {rec['renew_failures']}")
    if run["leftover"]:
        problems.append(f"files left behind: {run['leftover']}")
    return problems


def quantize_check(update: dict) -> dict:
    """The card's ``quantize`` against the CPU's on the same f32 tensors:
    payload and scales byte-equal, per int8 codec."""
    from hypha_tpu_torch.compress import quantize

    t0 = time.perf_counter()
    bad, n = [], 0
    for name, t in update.items():
        cpu = quantize(t, "int8")
        card = quantize(t.to("cuda"), "int8")
        if not (torch.equal(card[0].cpu(), cpu[0]) and torch.equal(card[1].cpu(), cpu[1])):
            bad.append(name)
        n += t.numel()
    return {"tensors": len(update), "elements": n, "mismatched": bad,
            "seconds": time.perf_counter() - t0}


def train_stream_phase() -> dict:
    """``train_node``'s job with ``STREAM_OPTIONS``: the trainer ships one
    int8 fragment a round from its flight thread while it keeps stepping,
    the server folds and re-encodes on the card."""
    from hypha_tpu_torch.executor.serialization import load_file
    from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor as PS

    root = Path(tempfile.mkdtemp(prefix="chip-smoke-stream-"))
    captured: dict = {}
    encode = PS._encode_broadcast

    def capture(self, update_path, codec, ef, work_dir, round_num, tag=None):
        if round_num == 0:  # round 0's f32 update: fragment 0, for the quantize check
            captured.update(load_file(update_path))
        return encode(self, update_path, codec, ef, work_dir, round_num, tag)

    PS._encode_broadcast = capture
    torch.cuda.reset_peak_memory_stats()
    try:
        run = asyncio.run(run_node_job(
            root, NODE_MODEL, device="cuda", rounds=STREAM_ROUNDS, steps=STREAM_STEPS,
            batch=TRAIN_BATCH, seq=TRAIN_SEQ, period=TRAIN_PERIOD,
            status_timeout=NODE_STATUS_TIMEOUT_S, job_options=STREAM_OPTIONS))
    finally:
        PS._encode_broadcast = encode
        shutil.rmtree(root, ignore_errors=True)
    server_peak = torch.cuda.max_memory_allocated() / 2**30
    rec, result = run["rec"], run["result"]
    log = "\n".join(rec["log"])
    trainer = trainer_log(log)
    timing = progress_timing(run)
    qcheck = quantize_check(captured)
    del captured
    step_s = trainer["step_s"] or {"flight": [], "no_flight": []}
    med = {k: statistics.median(v) * 1e3 if v else None for k, v in step_s.items()}
    everything = step_s["flight"] + step_s["no_flight"]
    step_ms = statistics.median(everything) * 1e3 if everything else None

    def at(xs, r):
        return [x for x in xs if x["round"] == r]

    per_round = []
    for r in range(STREAM_ROUNDS):
        push, bcast = at(rec["push"], r), at(rec["broadcast"], r)
        per_round.append({
            "round": r, "fragment": r % STREAM_OPTIONS["num_fragments"],
            "push_bytes": sum(x["bytes"] for x in push), "push_s": sum(x["s"] for x in push),
            "push_mb_per_s": [x["bytes"] / x["s"] / 1e6 for x in push],
            "broadcast_bytes": sum(x["bytes"] for x in bcast),
            "broadcast_s": sum(x["s"] for x in bcast),
            "broadcast_mb_per_s": [x["bytes"] / x["s"] / 1e6 for x in bcast],
            "fold_s": rec["fold_s"][r] if r < len(rec["fold_s"]) else None,
            "outer_step_s": rec["outer_step_s"][r] if r < len(rec["outer_step_s"]) else None,
            "encode_s": rec["encode_s"][r] if r < len(rec["encode_s"]) else None,
            **trainer["flights"].get(r, {}),
        })
    res = dict(
        model="llama2-7b", layers=NODE_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
        options=STREAM_OPTIONS, rounds=STREAM_ROUNDS, steps_a_round=STREAM_STEPS,
        jobs=run["jobs"], result_rounds=result.rounds,
        updated=[p["round"] for p in rec["progress"] if p["kind"] == "updated"],
        losses=[(w, r, m.get("loss")) for w, r, m in result.metrics],
        batches=trainer["batches"], per_round=per_round,
        step_ms=step_ms, step_ms_flight=med["flight"], step_ms_no_flight=med["no_flight"],
        steps_flight=len(step_s["flight"]), steps_no_flight=len(step_s["no_flight"]),
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3) if step_ms else None,
        round_boundary_s=timing["round_boundary_s"],
        progress_gap_max_s=timing["progress_gap_max_s"],
        progress_gap_between=timing["progress_gap_between"],
        adaptive_deadline_in_gap_s=timing["adaptive_deadline_in_gap_s"],
        handling_ms_median=timing["handling_ms_median"],
        trainer_peak_gib=trainer["peak_gib"], server_peak_gib=server_peak,
        attention_launches=trainer["launches"], quantize_check=qcheck,
        loop_stall_max_s=run["loop_stall_max_s"], leftover_files=run["leftover"],
    )
    problems = stream_problems(run, rounds=STREAM_ROUNDS,
                               fragments=STREAM_OPTIONS["num_fragments"],
                               expect=flat_f32_spec(NODE_MODEL), codec="int8")
    n = trainer["batches"] or 0
    want = {"fwd": 2 * NODE_LAYERS * n, "dq": NODE_LAYERS * n, "dkv": NODE_LAYERS * n,
            "flash_plain": 0, "dense": 0}
    if not n or "attention path: flash kernels" not in log or trainer["launches"] != want:
        problems.append(f"attention launches {trainer['launches']}, wanted {want} through the "
                        f"flash kernels for {n} batches")
    if qcheck["mismatched"] or not qcheck["tensors"]:
        problems.append(f"the card's quantize differs from the CPU's on {qcheck['mismatched']} "
                        f"of {qcheck['tensors']} tensors")
    if problems:
        emit({"phase": "train_stream", **res, "problems": problems, "worker_log_tail": log[-4000:]})
        raise SystemExit("train_stream phase failed: " + "; ".join(problems))
    return res


# ---------------------------------------------------------------------------
# train_secure: the stream job on a secured network of CLI processes
# ---------------------------------------------------------------------------

SECURE_ORG = "org-a"
# Start order; wx holds a certificate the org's CRL revokes.
SECURE_NODES = ("gateway", "data", "psw", "w0", "wx", "scheduler")
SECURE_KIND = {"gateway": "gateway", "data": "data", "psw": "worker", "w0": "worker",
               "wx": "worker", "scheduler": "scheduler"}
SECURE_ROUNDS, SECURE_STEPS = 2, 8
SECURE_WAIT_S = 900.0  # the job's deadline: bring-up, the rounds and the trainer's exit
_PEER_ID_LINE = {"gateway": r"gateway (\S+) on", "data": r"data node (\S+) on",
                 "worker": r"worker (\S+) on", "scheduler": r"scheduler (\S+) on"}
_PUSH = re.compile(r"push to (\S+): (\d+) bytes in ([\d.]+) s; header (\{.*\})")
_FABRIC = re.compile(r"fabric counts: (\{.*\})")


def certutil_pki(pki: Path, names, revoked) -> dict:
    """The port's certutil, each command a process of its own: the root,
    the org, a node certificate per name, then the org's CRL revoking
    ``revoked``. Returns each name's peer id as ``certutil node`` printed
    it."""
    repo = os.path.dirname(os.path.abspath(__file__))

    def certutil(*args) -> str:
        return subprocess.run(
            [sys.executable, "-m", "hypha_tpu_torch.certutil", *args, "--out", str(pki)],
            check=True, capture_output=True, text=True, cwd=repo, timeout=120).stdout

    certutil("root")
    certutil("org", "--name", SECURE_ORG)
    ids = {name: re.search(r"peer id: (\S+)", certutil("node", "--org", SECURE_ORG,
                                                       "--name", name)).group(1)
           for name in names}
    certutil("revoke", "--org", SECURE_ORG,
             *[a for name in revoked for a in ("--cert", str(pki / f"{name}.crt"))])
    return ids


def secure_job(model: dict, *, rounds: int, steps: int, batch: int, lr: float,
               options: dict) -> dict:
    """The scheduler's ``job.*`` keys for ``node_job``'s DiLoCo job."""
    return {"job.model_family": model["family"], "job.model_preset": model["preset"],
            "job.model_config": model["config"], "job.model_seed": model["seed"],
            "job.model_type": model["model_type"], "job.dataset": NODE_DATASET,
            "job.update_rounds": rounds, "job.avg_samples_between_updates": steps * batch,
            "job.max_batch_size": batch, "job.num_workers": 1, "job.worker_gpu": 1.0 / batch,
            "job.worker_memory": 1024, "job.ps_memory": 1024, "job.inner_lr": lr,
            **{f"job.{k}": v for k, v in options.items()}}


async def _plain_dial(addr: str) -> str:
    """A plain-TCP port node dialing ``addr``: the error it meets."""
    from hypha_tpu_torch.network import FrameError, Node, TcpTransport

    node = Node(TcpTransport(), peer_id="plain")
    await node.start(["127.0.0.1:0"])
    try:
        await asyncio.wait_for(node.dial(addr), 30)
        return ""
    except (ConnectionError, OSError, FrameError, asyncio.TimeoutError) as e:
        return f"{type(e).__name__}: {e}"
    finally:
        await node.stop()


async def run_secure_job(root: Path, model: dict, *, device: "str | None", rounds: int,
                         steps: int, batch: int, seq: int, period: int, lr: float,
                         options: dict) -> dict:
    """``node_job``'s job on a network of CLI processes, every node secured:
    the port's certutil writes a PKI under ``root/pki`` (``certutil_pki``:
    one certificate per node of ``SECURE_NODES``, wx's revoked), then each
    node runs ``python -m hypha_tpu_torch <kind> run`` from the TOML its
    ``init`` wrote, with a ``[tls]`` section naming its certificate, the
    trust root and the org's CRL, and ``network.mux`` on; ``w0`` runs its
    trainer with ``runtime = "process"`` and ``executor.cmd`` /
    ``executor.args`` naming the port's trainer CLI. Once the gateway, the
    data node, ``psw`` and ``w0`` are up, a plain-TCP node dials the
    gateway; then the scheduler runs the job and exits. When ``w0``'s and
    ``psw``'s jobs have ended, the rest get SIGTERM. ``root`` must be
    short: a trainer's bridge socket lives three levels below it. Returns
    the certutil ids, each role's log, exit code and stop seconds, the
    plain dial's error, bring-up and job seconds."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH", "")) if p)}
    cli = [sys.executable, "-m", "hypha_tpu_torch"]
    pki = root / "pki"
    t_pki = time.perf_counter()
    ids = certutil_pki(pki, SECURE_NODES, ["wx"])
    pki_s = time.perf_counter() - t_pki
    data_dir = root / "data"
    data_dir.mkdir()
    write_slices(data_dir, n_slices=2, per_slice=rounds * steps * batch // 2, seq=seq,
                 period=period, seed=5)
    run_inits(cli, {kind: root / f"{kind}.toml" for kind in ("gateway", "data", "worker",
                                                              "scheduler")}, env=env, cwd=repo)
    gateway = f"127.0.0.1:{_free_port()}"
    worker = {"resources.gpu": 1, "resources.cpu": 8, "resources.memory": 65536,
              "offer.strategy": "whole"}
    sets = {
        "gateway": {"network.listen": [gateway]},
        "data": {"datasets": {NODE_DATASET: str(data_dir)}},
        "psw": {"resources.gpu": 0, "resources.cpu": 8, "resources.memory": 65536},
        "w0": {**worker, "executor.runtime": "process", "executor.cmd": sys.executable,
               "executor.args": ["-m", "hypha_tpu_torch.executor.training",
                                 "--socket", "{SOCKET_PATH}", "--work-dir", "{WORK_DIR}",
                                 "--job", "{JOB_JSON}", "--device", "{DEVICE}"]},
        "wx": worker,
        "scheduler": secure_job(model, rounds=rounds, steps=steps, batch=batch, lr=lr,
                                options=options),
    }
    procs, logs, files, exits, stop_s = {}, {}, [], {}, {}
    loop = asyncio.get_running_loop()

    async def start(name: str) -> None:
        kind = SECURE_KIND[name]
        over = {"tls.cert": str(pki / f"{name}.crt"), "tls.key": str(pki / f"{name}.key"),
                "tls.trust": str(pki / "trust.crt"), "tls.crls": str(pki / f"{SECURE_ORG}.crl"),
                "network.mux": True, **sets[name]}
        if name != "gateway":
            over["network.gateways"] = [gateway]
        if kind == "worker":
            over["work_root"] = str(root / name)
        args = [*cli, kind, "run", "-c", str(root / f"{kind}.toml")]
        if kind == "worker" and device:
            args += ["--device", device]
        for key, value in over.items():
            args += ["--set", f"{key}={_toml_value(value)}"]
        logs[name] = root / f"{name}.log"
        files.append(open(logs[name], "wb"))
        procs[name] = await asyncio.create_subprocess_exec(
            *args, stdout=files[-1], stderr=subprocess.STDOUT, env=env, cwd=repo)

    def text(name: str) -> str:
        return logs[name].read_text(errors="replace")

    t0 = time.perf_counter()
    plain_error = None
    try:
        await start("gateway")
        await _wait_for_text(logs["gateway"], f"gateway {ids['gateway']} on", procs["gateway"],
                             loop.time() + NODE_WAIT_S)
        for name in ("data", "psw", "w0", "wx"):
            await start(name)
        for name, line in (("data", "data node"), ("psw", "worker"), ("w0", "worker")):
            await _wait_for_text(logs[name], f"{line} {ids[name]} on", procs[name],
                                 loop.time() + NODE_WAIT_S)
        bring_up_s = time.perf_counter() - t0
        plain_error = await _plain_dial(gateway)
        t_job = time.perf_counter()
        await start("scheduler")
        deadline = loop.time() + SECURE_WAIT_S
        exits["scheduler"] = await asyncio.wait_for(procs["scheduler"].wait(), SECURE_WAIT_S)
        stop_s["scheduler"] = 0.0
        scheduler_s = time.perf_counter() - t_job
        # The jobs end after the scheduler's last answer: each worker logs
        # its job's final state.
        for name in ("w0", "psw"):
            while not re.search(r"job \S+ (completed|failed|cancelled)", text(name)):
                if procs[name].returncode is not None or loop.time() > deadline:
                    break
                await asyncio.sleep(0.1)
        job_s = time.perf_counter() - t_job
    finally:
        for name in reversed(SECURE_NODES):
            p = procs.get(name)
            if p is None or name in exits:
                continue
            t = time.perf_counter()
            if p.returncode is None:
                p.send_signal(signal.SIGTERM)
            try:
                exits[name] = await asyncio.wait_for(p.wait(), STOP_WAIT_S)
            except asyncio.TimeoutError:
                p.kill()
                await p.wait()
                exits[name] = "killed"
            stop_s[name] = time.perf_counter() - t
        for f in files:
            f.close()
    leftover = sorted(str(p.relative_to(root)) for name in ("w0", "psw", "wx")
                      for p in (root / name).rglob("*") if p.is_file())
    return dict(ids=ids, logs={n: text(n) for n in logs}, exits=exits, stop_s=stop_s,
                plain_error=plain_error, pki_s=pki_s, bring_up_s=bring_up_s,
                scheduler_s=scheduler_s, job_s=job_s, leftover=leftover)


def secure_report(run: dict) -> dict:
    """What the secured network's logs say: each node's peer id as it
    printed it, the scheduler's rounds, losses, auction and dispatch
    (seconds between, from the log's clock), the largest progress gap and
    the watchdog, the parameter server's UPDATED rounds and broadcasts,
    ``w0``'s pushes and trainer lines (``trainer_log``), each worker's job
    states, the gateway's refused handshakes and every node's fabric
    counts."""
    logs = run["logs"]
    sched = logs["scheduler"]
    logged = {}
    for name, log in logs.items():
        found = re.search(_PEER_ID_LINE[SECURE_KIND[name]], log)
        logged[name] = found.group(1) if found else None

    def stamp(pattern: str, log: str):
        lines = [line for line in log.splitlines() if re.search(pattern, line)]
        return _log_time(lines[0]) if lines else None

    def pushes(log: str) -> list:
        return [{"to": to, "bytes": int(n), "s": float(s), "header": json.loads(h),
                 "mb_per_s": int(n) / float(s) / 1e6 if float(s) else None}
                for to, n, s, h in _PUSH.findall(log)]

    done = re.search(r"job (\S+) completed: (\d+) rounds", sched)
    dispatched = re.search(r"dispatched: parameter server on \[(.*)\], train on \[(.*)\]", sched)
    gap = re.search(r"largest progress gap ([\d.]+) s; the watchdog's least deadline "
                    r"([\d.]+|inf) s", sched)
    t_auction, t_dispatch = stamp("auctioning", sched), stamp("dispatched: ", sched)
    return dict(
        logged_ids=logged,
        rounds=int(done.group(2)) if done else None,
        losses=[(peer, int(r), float(v)) for peer, r, v in
                re.findall(r"metrics (\S+) round=(\d+) loss=(\S+)", sched)],
        dispatched_ps=re.findall(r"'([^']+)'", dispatched.group(1)) if dispatched else None,
        dispatched_train=re.findall(r"'([^']+)'", dispatched.group(2)) if dispatched else None,
        auction_to_dispatch_s=(t_dispatch - t_auction) if t_auction and t_dispatch else None,
        progress_gap_max_s=float(gap.group(1)) if gap else None,
        watchdog_min_s=float(gap.group(2)) if gap else None,
        updated=[int(r) for r in re.findall(r"ps \S+: round (\d+) UPDATED", logs["psw"])],
        broadcasts=pushes(logs["psw"]), pushes=pushes(logs["w0"]),
        trainer=trainer_log(logs["w0"]),
        job_states={name: re.findall(r"job \S+ (completed|failed|cancelled)", logs[name])
                    for name in ("w0", "psw", "wx")},
        refused=re.findall(r"TLS handshake from .* refused: (.*)", logs["gateway"]),
        fabric={name: json.loads(m[-1]) if (m := _FABRIC.findall(log)) else None
                for name, log in logs.items()},
    )


def secure_problems(run: dict, rep: dict, *, rounds: int, fragments: int) -> list:
    """The gates of the secured job, on the CPU as on the card: the
    scheduler's rounds and exit, ``UPDATED`` each round, both jobs
    completed, finite falling round losses, each node's peer id as its log
    states it equal to ``certutil node``'s, wx never up nor dispatched and
    refused by the gateway for revocation, the plain-TCP dial refused, one
    tagged push and one broadcast a round, every gossip frame verified
    (none dropped) and the scheduler's signed, every process out with 0
    within ``STOP_WAIT_S``, no file left in a work root."""
    ids = run["ids"]
    problems = []
    if rep["rounds"] != rounds or run["exits"].get("scheduler") != 0:
        problems.append(f"the scheduler completed {rep['rounds']} rounds and exited "
                        f"{run['exits'].get('scheduler')}; wanted {rounds} and 0")
    if rep["updated"] != list(range(rounds)):
        problems.append(f"the parameter server's UPDATED rounds {rep['updated']}")
    if rep["job_states"]["w0"] != ["completed"] or rep["job_states"]["psw"] != ["completed"]:
        problems.append(f"job states {rep['job_states']}")
    losses = [v for peer, _, v in rep["losses"] if peer == ids["w0"]]
    if len(losses) != rounds or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        problems.append(f"w0's round losses {losses}: not finite, or the last not below the first")
    wrong = {n: (rep["logged_ids"][n], ids[n]) for n in SECURE_NODES
             if n != "wx" and rep["logged_ids"][n] != ids[n]}
    if wrong:
        problems.append(f"logged peer ids differ from certutil's: {wrong}")
    if rep["dispatched_train"] != [ids["w0"]] or rep["dispatched_ps"] != [ids["psw"]]:
        problems.append(f"dispatched train on {rep['dispatched_train']}, the parameter server "
                        f"on {rep['dispatched_ps']}")
    if rep["logged_ids"]["wx"] is not None or rep["job_states"]["wx"] \
            or ids["wx"] in run["logs"]["scheduler"]:
        problems.append("the revoked worker wx came up or was dispatched")
    if not any("certificate revoked" in reason for reason in rep["refused"]):
        problems.append(f"the gateway refused no handshake for revocation: {rep['refused']}")
    if not run["plain_error"]:
        problems.append("a plain-TCP dial to the gateway succeeded")
    for what, xs in (("push", rep["pushes"]), ("broadcast", rep["broadcasts"])):
        tags = [{k: x["header"].get(k) for k in ("round", "fragment_id", "fragments")}
                for x in xs]
        want = [{"round": r, "fragment_id": r % fragments, "fragments": fragments}
                for r in range(rounds)]
        if sorted(tags, key=lambda t: t["round"] or 0) != want:
            problems.append(f"{what} headers {tags}, wanted {want}")
    fabric = rep["fabric"]
    if any(fabric.get(n) is None for n in SECURE_NODES):
        problems.append(f"fabric counts missing: {sorted(n for n in SECURE_NODES if not fabric.get(n))}")
    else:
        if fabric["scheduler"]["gossip"]["signed"] < 1:
            problems.append(f"the scheduler signed no gossip: {fabric['scheduler']}")
        if any(fabric[n]["gossip"]["dropped"] for n in SECURE_NODES) or \
                not all(fabric[n]["gossip"]["verified"] for n in ("gateway", "w0", "psw")):
            problems.append("gossip frames dropped, or a node verified none: "
                            f"{ {n: fabric[n]['gossip'] for n in SECURE_NODES} }")
    problems += exit_problems(run, SECURE_NODES)
    if run["leftover"]:
        problems.append(f"files left in the work roots: {run['leftover']}")
    return problems


def train_secure_phase(stream: dict) -> dict:
    """``train_stream``'s job (2 rounds) on a secured network of CLI
    processes (``run_secure_job``), held to ``secure_problems`` and to the
    flash launches of every batch trained; the TLS pushes and broadcasts
    beside ``stream``'s plain-TCP figures of the same run."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the card's memory to the worker processes
    root = Path(tempfile.mkdtemp(prefix="hss"))
    try:
        run = asyncio.run(run_secure_job(
            root, NODE_MODEL, device=None, rounds=SECURE_ROUNDS, steps=SECURE_STEPS,
            batch=TRAIN_BATCH, seq=TRAIN_SEQ, period=TRAIN_PERIOD, lr=3e-4,
            options=STREAM_OPTIONS))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rep = secure_report(run)
    trainer = rep["trainer"]
    problems = secure_problems(run, rep, rounds=SECURE_ROUNDS,
                               fragments=STREAM_OPTIONS["num_fragments"])
    n = trainer["batches"] or 0
    want = {"fwd": 2 * NODE_LAYERS * n, "dq": NODE_LAYERS * n, "dkv": NODE_LAYERS * n,
            "flash_plain": 0, "dense": 0}
    if not n or "attention path: flash kernels" not in run["logs"]["w0"] \
            or trainer["launches"] != want:
        problems.append(f"attention launches {trainer['launches']}, wanted {want} through the "
                        f"flash kernels for {n} batches")
    step_s = trainer["step_s"] or {"flight": [], "no_flight": []}
    med = {k: statistics.median(v) * 1e3 if v else None for k, v in step_s.items()}
    res = dict(
        model="llama2-7b", layers=NODE_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
        options=STREAM_OPTIONS, rounds=SECURE_ROUNDS, steps_a_round=SECURE_STEPS,
        openssl=ssl.OPENSSL_VERSION, peer_ids=run["ids"], exits=run["exits"],
        stop_s=run["stop_s"], plain_dial_error=run["plain_error"],
        refused=dict(collections.Counter(rep["refused"])),
        losses=rep["losses"], updated=rep["updated"], batches=n,
        pushes=[{k: x[k] for k in ("bytes", "s", "mb_per_s")} | {"round": x["header"]["round"]}
                for x in rep["pushes"]],
        broadcasts=[{k: x[k] for k in ("bytes", "s", "mb_per_s")}
                    | {"round": x["header"]["round"]} for x in rep["broadcasts"]],
        plain_tcp=[{k: r[k] for k in ("round", "push_bytes", "push_s", "push_mb_per_s",
                                      "broadcast_bytes", "broadcast_s", "broadcast_mb_per_s")}
                   for r in stream["per_round"]],
        flights=trainer["flights"], step_ms_flight=med["flight"],
        step_ms_no_flight=med["no_flight"], steps_flight=len(step_s["flight"]),
        steps_no_flight=len(step_s["no_flight"]), stream_step_ms_flight=stream["step_ms_flight"],
        stream_step_ms_no_flight=stream["step_ms_no_flight"],
        auction_to_dispatch_s=rep["auction_to_dispatch_s"],
        progress_gap_max_s=rep["progress_gap_max_s"], watchdog_min_s=rep["watchdog_min_s"],
        fabric=rep["fabric"], trainer_peak_gib=trainer["peak_gib"],
        attention_launches=trainer["launches"], pki_s=run["pki_s"],
        bring_up_s=run["bring_up_s"], scheduler_s=run["scheduler_s"], job_s=run["job_s"],
        seconds=time.perf_counter() - t0,
    )
    if problems:
        emit({"phase": "train_secure", **res, "problems": problems,
              "logs": {name: log[-3000:] for name, log in run["logs"].items()}})
        raise SystemExit("train_secure phase failed: " + "; ".join(problems))
    return res


# ------------------------------------------------------------- train_ft phase

# Fault-tolerant blocking DiLoCo at Llama-2-7B widths, FT_LAYERS layers: two
# trainers on one card at 8 layers (41-44 GiB each) do not fit in 80 GiB,
# and at 4 layers (1.07 B parameters) the phase's checkpoints peak near
# 90 GB (``ft_bytes_needed``) where the H100's machine has 80.2 GB free.
# 1 layer (2 until train_shard_ft joined the smoke) for the time limit:
# the phase's boundaries are set by its fsync'd state.
FT_LAYERS = 1
FT_MODEL = {"model_type": "causal-lm", "family": "llama", "preset": "llama2-7b",
            "seed": 0, "config": {"num_layers": FT_LAYERS, "remat": True}}
FT_ROUNDS, FT_STEPS = 6, 4  # 5 until kill-scheduler: round 5 runs under generation 2
FT_CHAOS = "kill-worker:1,kill-ps:3,kill-scheduler:4"
FT_EVERY = 2  # ps_checkpoint_every_rounds: round 2's commit is replayed
FT_CKPT_EVERY = 4  # checkpoint_every: each trainer saves its last round (2 before train_shard_ft)
# The elastic round deadline: about 3x the healthy collection of round 0
# (the parameter server's open to its close, the trainers' start-up
# inside: 23.19 s on an H100 80GB HBM3 at 700 W; PERF.md §4). No round
# reaches it here: round 1 closes when w1 departs, and the round a
# rejoiner's catch-up blocks the server's collect in (25 s) stays inside.
FT_DEADLINE_S = 70.0
FT_WAIT_S = 900.0  # the phase's scheduler deadline
# The scheduler outage's cap: each log line the restart waits for (the
# server's broadcast-first, each trainer's parked UPDATE_RECEIVED) must come
# within it, or the phase fails (and the scheduler restarts anyway).
FT_OUTAGE_CAP_S = 60.0
# The reference's fixed restart budget beside one round (its
# ``benchmarks/ft_chaos.py``): the bound the outage's added wall is held to.
FT_RESTART_BUDGET_S = 10.0


def ft_job(model: dict, *, rounds, steps, batch, lr, deadline_s, checkpoint_dir):
    """``node_job`` for two workers with int8 deltas, elastic rounds
    (quorum 0.5), one parameter-server restart, trainer checkpoints and
    the durable server under ``checkpoint_dir``, every ``FT_CKPT_EVERY``
    and ``FT_EVERY`` rounds, and scheduler recovery (its journal under
    ``checkpoint_dir``, the default adoption grace and deadline). The
    rejoin attempts outlast the wait for the spare worker."""
    from hypha_tpu_torch.ft import FTConfig

    return node_job(model, rounds=rounds, steps=steps, batch=batch, lr=lr, workers=2,
                    delta_codec="int8",
                    ft=FTConfig(quorum_fraction=0.5, round_deadline_s=deadline_s,
                                rejoin_attempts=60, rejoin_backoff_s=1.0,
                                ps_restart_attempts=1, ps_restart_backoff_s=1.0),
                    checkpoint_dir=str(checkpoint_dir), checkpoint_every=FT_CKPT_EVERY,
                    ps_checkpoint_every_rounds=FT_EVERY, scheduler_recovery=True)


class ThetaTrack:
    """θ₀ of the job's seed (built on ``device``, as the trainers build it)
    and Σ of the decoded updates the server broadcast, accumulated on the
    device one f32 add a round as the server's ``CatchupBuffer`` adds on
    the host (a replayed round once). ``catchups`` holds, for each
    catch-up the server serves, whether its Σ equals this one bit for bit
    and the checksum (``theta_checksum``, the trainers' digest) of θ₀ + Σ:
    the rejoiner's θ after its merge."""

    def __init__(self, model: dict, device) -> None:
        from hypha_tpu_torch.executor.training import theta_checksum
        from hypha_tpu_torch.models.convert import state_to_flat
        from hypha_tpu_torch.models.registry import build_model

        built, _ = build_model(model, device=device)
        built.init_weights(int(model.get("seed", 0)))
        self.theta0 = {k: v.detach().float().contiguous()
                       for k, v in state_to_flat(built, built.state_dict()).items()}
        del built
        self.checksum = theta_checksum
        self.sum: dict = {}  # on the device: one f32 add a round, as the host's
        self.rounds: list = []
        self.catchups: list = []

    def accumulate(self, round_num: int, update: dict) -> None:
        if round_num in self.rounds:
            return  # a recovered server's replay of a broadcast round
        self.rounds.append(round_num)
        for name, u in update.items():
            t = u.detach().to(self.theta0[name].device, torch.float32)
            if name in self.sum:
                self.sum[name].add_(t)
            else:
                self.sum[name] = t.clone()

    def catchup(self, rounds: int, cum: dict, shards: int = 1) -> None:
        """One served catch-up: ``cum`` is the server's Σ over ``rounds``.
        With ``shards`` > 1 a shard's Σ covers its own tensors: it must
        equal this Σ on those, and θ₀ + Σ over every tensor is what the
        rejoiner holds once it merged the union of the shards' catch-ups."""
        same_keys = set(cum) <= set(self.sum) if shards > 1 else set(cum) == set(self.sum)
        equal = same_keys and all(
            cum[k].tobytes() == self.sum[k].cpu().numpy().tobytes() for k in cum)
        theta = {k: p + self.sum[k].reshape(p.shape) if k in self.sum else p
                 for k, p in self.theta0.items()}
        self.catchups.append({"rounds": rounds, "sum_equal": equal, "keys": sorted(cum),
                              "broadcast_rounds": list(self.rounds),
                              "checksum": self.checksum(theta)})


@contextmanager
def ft_probes(rec: dict, theta: "ThetaTrack | None", on_fold, on_dedup, shards: int = 1):
    """The durable server and the elastic scheduler from inside: each
    journal record and its bytes (both generations; by durable root too),
    each fold journaled (generation, round, key, root, partial and covers)
    with ``on_fold(round, key, covers)`` called on the loop, each dedup hit
    (``on_dedup()``), each round wire the server stores with its sha-256,
    each elastic or pipelined collect (round, open, close, keys), each
    departure and rejoin the scheduler makes; and, with a ``theta``, each
    broadcast update accumulated into it and each catch-up Σ checked
    against it (a shard's against its own tensors when ``shards`` > 1)."""
    import hashlib

    from hypha_tpu_torch.ft.durable import DurablePS, RoundJournal
    from hypha_tpu_torch.ft.rejoin import CatchupBuffer
    from hypha_tpu_torch.scheduler.orchestrator import Orchestrator
    from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor as PS

    saved = (RoundJournal.append, DurablePS.note_fold, DurablePS.already_folded,
             DurablePS.store_wire, PS._collect_round_elastic, PS._collect_round_stream,
             PS._encode_broadcast, CatchupBuffer.write, Orchestrator._depart,
             Orchestrator._rejoin_worker)
    (append, note_fold, folded, store_wire, collect, collect_stream, encode, write, depart,
     rejoin) = saved
    loop = asyncio.get_running_loop()

    def counted_append(self, record, *, sync=False):
        before = self.bytes_written
        append(self, record, sync=sync)
        rec["journal"].append((record.get("t"), self.bytes_written - before))
        rec["journal_by_root"].append((self.path.parent.name, record.get("t"),
                                       self.bytes_written - before))

    def noted_fold(self, fold, *, sync=False):
        note_fold(self, fold, sync=sync)
        rec["folds"].append({"generation": self.generation, "round": fold.round,
                             "peer": fold.peer, "root": self.root.name,
                             "prefold": fold.prefold, "covers": list(fold.covers)})
        loop.call_soon_threadsafe(on_fold, fold.round, fold.peer, list(fold.covers))

    def noted_dedup(self, round_num, fragment, peer, sha):
        hit = folded(self, round_num, fragment, peer, sha)
        if hit:
            rec["dedup_hits"].append({"generation": self.generation, "round": round_num,
                                      "peer": peer, "root": self.root.name})
            on_dedup()
        return hit

    def hashed_store(self, round_num, wire_src):
        h = hashlib.sha256(Path(wire_src).read_bytes()).hexdigest()
        rec["wires"].append({"generation": self.generation, "round": round_num, "sha256": h,
                             "root": self.root.name})
        return store_wire(self, round_num, wire_src)

    async def timed_collect(self, consumer, job_id, st, cfg, work_dir, round_num, accum, dur=None,
                            **kw):
        t0 = time.perf_counter()
        received = await collect(self, consumer, job_id, st, cfg, work_dir, round_num, accum, dur,
                                 **kw)
        rec["collects"].append({"round": round_num, "t0": t0, "t1": time.perf_counter(),
                                "peers": sorted(received),
                                "generation": dur.generation if dur else None,
                                "active": list(st.membership.active)})
        return received

    async def timed_collect_stream(self, consumer, job_id, *args, **kw):
        t0 = time.perf_counter()
        received = await collect_stream(self, consumer, job_id, *args, **kw)
        st, dur = kw.get("st"), kw.get("dur")
        rec["collects"].append({"round": args[3], "t0": t0, "t1": time.perf_counter(),
                                "peers": sorted(received),
                                "generation": dur.generation if dur else None,
                                "root": dur.root.name if dur else None,
                                "active": list(st.membership.active) if st else None})
        return received

    def merged_encode(self, update_path, codec, ef, work_dir, round_num, tag=None):
        wire, sent = encode(self, update_path, codec, ef, work_dir, round_num, tag)
        if theta is not None:
            from hypha_tpu_torch.compress import read_delta

            theta.accumulate(round_num,
                             sent if sent is not None else read_delta(wire, device="cpu"))
        return wire, sent

    def checked_write(self, path):
        if theta is not None:
            theta.catchup(self.rounds, self._cum, shards)
        return write(self, path)

    async def noted_depart(self, ctx, peer, reason, add):
        if ctx.membership is not None and peer in ctx.membership.active:
            rec["departures"].append({"peer": peer, "t": time.perf_counter(), "reason": reason})
        return await depart(self, ctx, peer, reason, add)

    async def noted_rejoin(self, ctx, departed_peer, departed_at):
        joined = await rejoin(self, ctx, departed_peer, departed_at)
        if joined is not None:
            rec["rejoins"].append({"peer": joined[0].peer_id, "for": departed_peer,
                                   "t": time.perf_counter()})
        return joined

    for key in ("journal", "journal_by_root", "folds", "dedup_hits", "wires", "collects",
                "departures", "rejoins"):
        rec.setdefault(key, [])
    RoundJournal.append, DurablePS.note_fold = counted_append, noted_fold
    DurablePS.already_folded, DurablePS.store_wire = noted_dedup, hashed_store
    PS._collect_round_elastic, PS._encode_broadcast = timed_collect, merged_encode
    PS._collect_round_stream = timed_collect_stream
    CatchupBuffer.write = checked_write
    Orchestrator._depart, Orchestrator._rejoin_worker = noted_depart, noted_rejoin
    try:
        yield rec
    finally:
        (RoundJournal.append, DurablePS.note_fold, DurablePS.already_folded, DurablePS.store_wire,
         PS._collect_round_elastic, PS._collect_round_stream, PS._encode_broadcast,
         CatchupBuffer.write, Orchestrator._depart, Orchestrator._rejoin_worker) = saved


def _gated_push(node, gates: dict) -> None:
    """Hold this node's delta pushes of round ``r`` until ``gates[r]()``
    (a coroutine function; None lets the push go) returns."""
    push = node.push

    async def gated(peer_id, resource, source):
        r = resource if isinstance(resource, dict) else {}
        gate = gates.get(r.get("round"))
        if gate is not None and str(r.get("resource", "")).startswith("updates"):
            await gate(node.peer_id)
        return await push(peer_id, resource, source)

    node.push = gated


async def run_ft_job(root: Path, model: dict, *, device, rounds, steps, batch, seq, period,
                     lr=3e-4, deadline_s=FT_DEADLINE_S, limit_s=CLI_LIMIT_S,
                     train_runtime="process", auction_timeout=2.0, status_timeout=None,
                     track_theta=True, sample_card=False) -> dict:
    """``ft_job`` on the port's nodes at 127.0.0.1 (``run_node_job``'s
    fabric): gateway, data node, train workers ``w0`` and ``w1``, ``psw``
    hosting the parameter server, the port's ``Orchestrator``, and a
    ``ChaosController`` on ``FT_CHAOS``:

      * ``kill-worker:1`` — ``w1`` is killed once the server journaled
        its round-0 delta, so round 0 has both deltas and round 1 runs
        without it; once the kill finished (its trainer process gone) and
        round 1 closed, a spare ``w2`` starts and offers, so the
        scheduler's rejoin auction takes it and the server serves it the
        catch-up Σ;
      * ``kill-ps:3`` — ``psw`` is killed when round 3's first delta is
        journaled. A new ``psw`` node (same peer id, a new port) starts a
        second later; the scheduler's restart re-dispatches the aggregate
        job to it, which recovers from ``<root>/ckpt/ps``;
      * ``kill-scheduler:4`` — the scheduler's node is stopped and its
        ``run`` cancelled once round 4's first delta is journaled and
        both trainers' round-4 METRICS were answered (after it a trainer
        waits for the broadcast). The second delta folds, the server's
        notify fails twice and it broadcasts round 4 without the
        scheduler, both trainers merge it and their UPDATE_RECEIVED parks
        in the bridge's retry; only after those log lines (each within
        ``FT_OUTAGE_CAP_S``) a new ``Orchestrator`` on a new ``Node``
        (same peer id, a new port) runs the same job, finds the journal
        under ``<root>/ckpt/scheduler`` and adopts the executions.

    Three holds make the schedule deterministic (``_gated_push``): round-2
    deltas wait until the rejoin is done, so the catch-up comes at round
    2 (Σ of rounds 0 and 1); the second worker's round-3 delta waits until
    the first worker's re-send to the restarted server was deduplicated,
    so exactly one was journaled before the kill and one re-send is a
    dedup hit; the second worker's round-4 delta waits until the
    scheduler is dead. None changes what a worker computes.

    Returns what ``node_probes`` and ``ft_probes`` saw, the logs of the
    trainers, the server and the scheduler, the chaos times, the disk use
    of ``root`` before and after, the checkpoint tree and the files left
    outside it, and (with ``sample_card``) the card's peak memory."""
    import logging

    from hypha_tpu_torch import aio
    from hypha_tpu_torch.data_node import DataNode
    from hypha_tpu_torch.ft import ChaosController, parse_chaos_specs
    from hypha_tpu_torch.gateway import Gateway
    from hypha_tpu_torch.network import Node, TcpTransport
    from hypha_tpu_torch.resources import Resources
    from hypha_tpu_torch.scheduler.orchestrator import Orchestrator
    from hypha_tpu_torch.worker.arbiter import OfferConfig
    from hypha_tpu_torch.worker.runtime import WorkerNode

    disk_before = shutil.disk_usage(root)
    data_dir, ckpt = root / "data", root / "ckpt"
    data_dir.mkdir(parents=True)
    write_slices(data_dir, n_slices=4, per_slice=rounds * steps * batch, seq=seq, period=period,
                 seed=5)
    job = ft_job(model, rounds=rounds, steps=steps, batch=batch, lr=lr, deadline_s=deadline_s,
                 checkpoint_dir=ckpt)
    theta = ThetaTrack(model, device) if track_theta else None
    listen = ["127.0.0.1:0"]

    def worker(name: str) -> "WorkerNode":
        return WorkerNode(TcpTransport(), resources=Resources(gpu=1, cpu=8, memory=65536),
                          device=device, peer_id=name, train_runtime=train_runtime,
                          offer=OfferConfig(strategy="whole"), bootstrap=boot,
                          work_root=root / name)

    def server(work: str) -> "WorkerNode":
        return WorkerNode(TcpTransport(), resources=Resources(cpu=8, memory=65536), device=device,
                          peer_id="psw", bootstrap=boot, work_root=root / work)

    gw = Gateway(TcpTransport(), peer_id="gw")
    await gw.start(listen)
    boot = [gw.node.listen_addrs[0]]
    data = DataNode(TcpTransport(), {NODE_DATASET: data_dir}, peer_id="data", bootstrap=boot)
    w0, w1, psw = worker("w0"), worker("w1"), server("ps")
    node = Node(TcpTransport(), peer_id="sched", bootstrap=boot)

    class SchedulerProcess:
        """The chaos target of ``kill-scheduler``: its node stops first,
        then ``stop`` cancels the orchestrator's ``run`` (the process dies)."""

        def __init__(self) -> None:
            self.node, self.run = node, None

        async def stop(self) -> None:
            if self.run is not None:
                self.run.cancel()
                await asyncio.gather(self.run, return_exceptions=True)

    sched_proc = SchedulerProcess()
    actions = parse_chaos_specs(FT_CHAOS, "w1")
    for a in actions:
        a.target = {"kill-ps": "psw", "kill-scheduler": "sched"}.get(a.kind, "w1")
    chaos = ChaosController(actions, {"w0": w0, "w1": w1, "psw": psw, "sched": sched_proc},
                            clock=time.perf_counter)
    ps_fired, joined, deduped = asyncio.Event(), asyncio.Event(), asyncio.Event()
    r4_folded, sched_dead = asyncio.Event(), asyncio.Event()
    first_r3: list = []
    first_r4: list = []

    async def after_join(_peer: str) -> None:
        await joined.wait()

    async def second_after_dedup(peer: str) -> None:
        if first_r3 and first_r3[0] != peer:
            await deduped.wait()
        elif not first_r3:
            first_r3.append(peer)

    async def second_after_kill(peer: str) -> None:
        if first_r4 and first_r4[0] != peer:
            await sched_dead.wait()
        elif not first_r4:
            first_r4.append(peer)

    gates = {2: after_join, 3: second_after_dedup, 4: second_after_kill}

    def on_fold(round_num: int, peer: str, _covers=None) -> None:
        # The kills' round triggers: w1's once its round-0 delta is
        # journaled (round 1 is then what it misses), the server's at round
        # 3's first journaled delta.
        if (round_num, peer) == (0, "w1"):
            chaos.on_round_metrics(0)  # kill-worker:1: round 1 is running
        elif round_num == 3 and not ps_fired.is_set():
            chaos.on_round_metrics(2)  # kill-ps:3: round 3 is running
            ps_fired.set()
        elif round_num == 4:
            r4_folded.set()

    logs: dict = {"ps": [], "sched": [], "bridge": []}

    class Lines(logging.Handler):
        def __init__(self, key):
            super().__init__()
            self.key = key

        def emit(self, record):
            logs[self.key].append(f"{time.perf_counter():.3f} {record.getMessage()}")

    handlers = [(logging.getLogger(n), Lines(k)) for n, k in (
        ("hypha.torch.worker.ps", "ps"), ("hypha.torch.ft.durable", "ps"),
        ("hypha.torch.scheduler.orchestrator", "sched"), ("hypha.torch.worker.bridge", "bridge"))]
    levels = [lg.level for lg, _ in handlers]
    for lg, h in handlers:
        lg.addHandler(h)
        lg.setLevel(logging.INFO)
    started: list = []
    stop_errors: list = []
    extra: dict = {}
    stalls: list = []
    peak = [0.0]
    sampling = asyncio.Event()
    tasks = [asyncio.create_task(watch_loop(stalls))]
    if sample_card:
        tasks.append(asyncio.create_task(_device_mem_sampler(peak, sampling)))

    async def restarter(rec) -> None:
        """The spare worker after w1's kill and round 1's close; a new psw
        after the server's kill."""
        while chaos.fired_at("w1") is None:
            await asyncio.sleep(0.05)
        await chaos.drain()
        extra["w1_dead_t"] = time.perf_counter()
        while 1 not in [p["round"] for p in rec["progress"] if p["kind"] == "updated"]:
            await asyncio.sleep(0.05)
        w2 = worker("w2")
        _gated_push(w2.node, gates)
        await w2.start(listen)
        started.append(w2)
        extra["w2_up_t"] = time.perf_counter()
        while not rec["rejoins"]:
            await asyncio.sleep(0.05)
        joined.set()
        await ps_fired.wait()
        await chaos.drain()
        # The gateway drops a closed peer's registrations by peer id: a
        # node started under the same id before it noticed would lose its
        # own (the reference's chaos harness waits 0.3 s here).
        await asyncio.sleep(1.0)
        psw2 = server("ps2")
        await psw2.start(listen)
        started.append(psw2)
        extra["psw2_up_t"] = time.perf_counter()

    async def scheduler_killer(rec) -> None:
        """kill-scheduler:4 once round 4's first delta is journaled and both
        trainers' round-4 METRICS were answered."""
        await r4_folded.wait()
        while {p["peer"] for p in rec["progress"]
               if p["kind"] == "metrics" and p["round"] == 4} < {"w0", "w2"}:
            await asyncio.sleep(0.05)
        chaos.on_round_metrics(3)  # kill-scheduler:4: round 4 is running

    async def outage_lines(rec) -> list:
        """Wait, each within FT_OUTAGE_CAP_S, for the server's broadcast of
        round 4 and both trainers' parked UPDATE_RECEIVED; returns what
        did not come."""
        job_peer = {d["job_id"]: d["peer"] for d in rec["dispatch"] if d["kind"] == "train"}

        def parked() -> set:
            return {peer for job, peer in job_peer.items() if any(
                f"status update-received of {job} -> scheduler': attempt" in line
                for line in logs["bridge"])}

        waits = (("the server's broadcast-first of round 4", lambda: any(
                     "round 4 UPDATED failed twice; broadcasting" in line
                     for line in logs["ps"]) and any(b["round"] == 4 for b in rec["broadcast"])),
                 ("both trainers' parked UPDATE_RECEIVED", lambda: parked() >= {"w0", "w2"}))
        missing = []
        loop = asyncio.get_running_loop()
        for what, ready in waits:
            deadline = loop.time() + FT_OUTAGE_CAP_S
            while not ready() and loop.time() < deadline:
                await asyncio.sleep(0.05)
            if not ready():
                missing.append(f"{what} not seen within {FT_OUTAGE_CAP_S:.0f} s")
        return missing

    with node_probes(device) as rec, ft_probes(rec, theta, on_fold, deduped.set):
        restart = None
        try:
            for part in (data, w0, w1, psw, node):
                await part.start(listen)
                started.append(part)
            for w in (w0, w1):
                _gated_push(w.node, gates)
            await node.wait_for_bootstrap()
            restart = asyncio.create_task(restarter(rec))
            killer = asyncio.create_task(scheduler_killer(rec))
            t_job = time.perf_counter()
            sched_proc.run = asyncio.create_task(Orchestrator(node).run(
                job, auction_timeout=auction_timeout, status_timeout=status_timeout))
            await asyncio.wait([sched_proc.run])
            if sched_proc.run.cancelled():
                # The kill: the journal outlives the process; a new node
                # under the same peer id restarts the scheduler.
                await chaos.drain()
                extra["sched_kill_t"] = chaos.fired_at("sched")
                sched_dead.set()
                extra["outage_missing"] = await outage_lines(rec)
                node2 = Node(TcpTransport(), peer_id="sched", bootstrap=boot)
                await node2.start(listen)
                started.append(node2)
                extra["sched_restart_t"] = time.perf_counter()
                await node2.wait_for_bootstrap()
                orch = Orchestrator(node2)
                result = await orch.run(job, auction_timeout=auction_timeout,
                                        status_timeout=status_timeout)
                extra["sched_counts"] = dict(orch.counts)
            else:
                result = sched_proc.run.result()
            extra["job_s"] = time.perf_counter() - t_job
            final = {"completed", "failed", "cancelled"}
            loop = asyncio.get_running_loop()
            deadline = loop.time() + limit_s
            while True:
                live = {d["job_id"] for d in rec["dispatch"] if d["peer"] != "w1"}
                ended = {s["job_id"] for s in rec["statuses"] if s["state"] in final}
                finished = live <= ended
                if finished or loop.time() > deadline:
                    break
                await asyncio.sleep(0.1)
        finally:
            if restart is not None:
                await aio.reap(restart, killer)
            sampling.set()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            for part in reversed(started):
                try:
                    await part.stop()
                except Exception as e:  # noted; ft_problems fails on it
                    stop_errors.append(f"{getattr(part, 'peer_id', part)}: {e!r}")
            await gw.stop()
            for (lg, h), level in zip(handlers, levels):
                lg.removeHandler(h)
                lg.setLevel(level)
    leftover: list = []
    for _ in range(300):
        leftover = sorted(str(p.relative_to(root)) for p in root.rglob("*")
                          if p.is_file() and not p.is_relative_to(data_dir)
                          and not p.is_relative_to(ckpt))
        if not leftover:
            break
        await asyncio.sleep(0.1)
    tree = sorted((str(p.relative_to(ckpt)), p.stat().st_size) for p in ckpt.rglob("*")
                  if p.is_file())
    jobs = {}
    for d in rec["dispatch"]:
        key = d["peer"] if d["kind"] == "train" else "aggregate"
        jobs[key] = [s["state"] for s in rec["statuses"] if s["job_id"] == d["job_id"]]
    extra["sched_journal_left"] = (ckpt / "scheduler" / "sched-journal.cbor").exists()
    return dict(job=job, result=result, rec=rec, finished=finished, logs=logs, theta=theta,
                chaos={a.kind: a.fired_at for a in chaos.fired}, jobs=jobs, extra=extra,
                stop_errors=stop_errors, leftover=leftover, checkpoints=tree, ckpt=ckpt,
                disk_before=disk_before, disk_after=shutil.disk_usage(root),
                card_peak_mib=peak[0] if sample_card else None,
                loop_stall_max_s=max(stalls, default=0.0))


_LINE_JOB = re.compile(r"^\[([^\]]+)\] (.*)$")
_CHECKSUM = re.compile(r"round (\d+): anchor checksum (\w+)")
_CKPT_SAVE = re.compile(r"round (\d+): checkpoint (\S+) saved in ([\d.]+) s \((\d+) bytes\)")
_PS_CKPT = re.compile(r"durable ps checkpoint: next_round \d+ -> (\d+) \(\d+ tensors, (\d+) bytes "
                      r"in ([\d.]+) s")
_CATCHUP = re.compile(r"served catch-up \((\d+) rounds, next (\d+)\) to rejoiner (\S+): (\d+) "
                      r"bytes in ([\d.]+) s")
_REPLAY = re.compile(r"recovered durable state \(generation (\d+)\): resuming round (\d+) \((\d+) "
                     r"committed rounds replayed in ([\d.]+) s\)")


def trainer_logs(run: dict) -> dict:
    """Each train job's log lines (the worker's copy of its trainer's
    output), keyed by the peer it was dispatched to."""
    peer_of = {d["job_id"]: d["peer"] for d in run["rec"]["dispatch"] if d["kind"] == "train"}
    out: dict = {peer: [] for peer in peer_of.values()}
    for line in run["rec"]["log"]:
        m = _LINE_JOB.match(line)
        if m and m.group(1) in peer_of:
            out[peer_of[m.group(1)]].append(m.group(2))
    return out


def ft_report(run: dict) -> dict:
    """What ``run_ft_job`` measured, from its stamps and the logs."""
    rec, logs = run["rec"], trainer_logs(run)
    ps_log, sched_log = "\n".join(run["logs"]["ps"]), "\n".join(run["logs"]["sched"])
    per: dict = {}
    for peer, lines in logs.items():
        text = "\n".join(lines)
        found = re.search(r"attention launches: (\{.*\})", text)
        peak = re.search(r"peak device memory: ([\d.]+) GiB", text)
        per[peer] = {
            "checksums": [(int(r), c) for r, c in _CHECKSUM.findall(text)],
            "rejoin": re.search(r"rejoin: caught up to round (\d+) .*?: (\d+) bytes, waited "
                                r"([\d.]+) s, merged in ([\d.]+) s", text),
            "checkpoints": [{"round": int(r), "version": v, "s": float(s), "bytes": int(b)}
                            for r, v, s, b in _CKPT_SAVE.findall(text)],
            "launches": json.loads(found.group(1)) if found else None,
            "peak_gib": float(peak.group(1)) if peak else None,
            "batches": sum(p["kind"] == "status" and p["peer"] == peer for p in rec["progress"]),
        }
    for peer, p in per.items():
        m = p.pop("rejoin")
        p["rejoin"] = m and {"round": int(m.group(1)), "bytes": int(m.group(2)),
                             "wait_s": float(m.group(3)), "merge_s": float(m.group(4))}
    fired = run["chaos"]
    deps = {d["peer"]: d["t"] for d in rec["departures"]}
    first_beat = {}
    for p in rec["progress"]:
        if p["kind"] == "status":
            first_beat.setdefault(p["peer"], p["t"])
    gen2 = [b for b in rec["broadcast"] if (b["header"] or {}).get("ps_generation") == 2]
    r1 = [c for c in rec["collects"] if c["round"] == 1]
    replay = _REPLAY.search(ps_log)
    catchups = _CATCHUP.findall(ps_log)
    return dict(
        trainers=per,
        collects=[{"round": c["round"], "s": c["t1"] - c["t0"], "peers": c["peers"],
                   "generation": c["generation"], "active": c["active"]}
                  for c in rec["collects"]],
        round1_close_wait_s=(r1[0]["t1"] - r1[0]["t0"]) if r1 else None,
        kill_to_departure_s=(deps["w1"] - fired["kill"]) if "w1" in deps and "kill" in fired
        else None,
        departure_to_w2_beat_s=(first_beat["w2"] - deps["w1"]) if "w2" in first_beat
        and "w1" in deps else None,
        catchup=[{"rounds": int(a), "round": int(b), "peer": c, "bytes": int(d), "s": float(e)}
                 for a, b, c, d, e in catchups],
        ps_kill_to_gen2_broadcast_s=(min(b["t0"] for b in gen2) - fired["kill-ps"])
        if gen2 and "kill-ps" in fired else None,
        replay=replay and {"generation": int(replay.group(1)), "resumes": int(replay.group(2)),
                           "replayed": int(replay.group(3)), "s": float(replay.group(4))},
        ps_checkpoints=[{"next_round": int(a), "bytes": int(b), "s": float(c)}
                        for a, b, c in _PS_CKPT.findall(ps_log)],
        journal_records=len(rec["journal"]), journal_bytes=sum(n for _, n in rec["journal"]),
        dedup_hits=rec["dedup_hits"], wires=rec["wires"], folds=rec["folds"],
        updated=sorted(p["round"] for p in rec["progress"] if p["kind"] == "updated"),
        degraded=re.findall(r"round (\d+) DEGRADED — aggregating (\d+) of (\d+)(.*)", ps_log),
        quorum_drops=re.findall(r"round (\d+) quorum drop: (.*)", ps_log),
        generations=sorted({int(g) for g in re.findall(r"durable state at \S+, generation (\d+)",
                                                       ps_log)}),
        departures=[(d["peer"], d["reason"]) for d in rec["departures"]],
        rejoins=[(r["peer"], r["for"]) for r in rec["rejoins"]],
        ps_restarts=re.findall(r"parameter server shard \d+ restarted on (\S+)", sched_log),
        theta=run["theta"] and {"catchups": run["theta"].catchups,
                                 "broadcast_rounds": list(run["theta"].rounds)},
        scheduler=scheduler_report(run),
        disk_free_gb=(run["disk_before"].free / 1e9, run["disk_after"].free / 1e9),
        checkpoint_bytes=sum(n for _, n in run["checkpoints"]),
    )


_SCHED_ADOPT = re.compile(r"^([\d.]+) adoption: (\S+) on (\S+) answered (\w+) \(round (\d+), "
                          r"epoch (\d+)\)")
_SCHED_RECOVERY = re.compile(r"^([\d.]+) scheduler recovery: generation (\d+) adopting")
_SCHED_FORWARD = re.compile(r"adopted (\d+)/(\d+) executions, fast-forwarded round (\d+) -> "
                            r"(\d+)")
_SCHED_JOURNAL = re.compile(r"scheduler journal generation (\d+), (\d+) records, (\d+) bytes; "
                            r"recovery counts (\{.*\})")
_PARKED = re.compile(r"job (\S+): status (\S+) answered after (\d+) parked attempt\(s\) in "
                     r"([\d.]+) s \(scheduler generation (\S+), round (\S+)\)")
_PS_PARKED = re.compile(r"round (\d+) UPDATED answered after (\d+) parked attempt\(s\) in "
                        r"([\d.]+) s \(scheduler generation (\S+), round (\S+)\)")


def scheduler_report(run: dict) -> "dict | None":
    """The scheduler's kill and restart (``run_ft_job``'s kill-scheduler),
    from the stamps and the logs; None when the scheduler was not killed."""
    extra, rec = run["extra"], run["rec"]
    kill_t, restart_t = extra.get("sched_kill_t"), extra.get("sched_restart_t")
    if kill_t is None or restart_t is None:
        return None
    sched_log, ps_log = run["logs"]["sched"], "\n".join(run["logs"]["ps"])
    job_peer = {d["job_id"]: d["peer"] for d in rec["dispatch"]}
    acks = [{"t": float(m.group(1)), "job": m.group(2), "peer": m.group(3),
             "state": m.group(4), "round": int(m.group(5)), "epoch": int(m.group(6))}
            for m in map(_SCHED_ADOPT.match, sched_log) if m]
    recoveries = [int(m.group(2)) for m in map(_SCHED_RECOVERY.match, sched_log) if m]
    forward = _SCHED_FORWARD.search("\n".join(sched_log))
    journal = [(r, n) for root, r, n in rec["journal_by_root"] if root == "scheduler"]
    updated = {}
    for p in rec["progress"]:
        if p["kind"] == "updated":
            updated.setdefault(p["round"], p["t"])
    walls = {r: updated[r] - updated[r - 1] for r in updated if r - 1 in updated}
    base = [walls[r] for r in (1, 2, 3) if r in walls]
    parked = [{"peer": job_peer.get(m.group(1), m.group(1)), "kind": m.group(2),
               "attempts": int(m.group(3)), "s": float(m.group(4)),
               "generation": m.group(5), "round": m.group(6)}
              for m in (_PARKED.search(line) for line in run["logs"]["bridge"]) if m]
    ps_parked = [{"round": int(a), "attempts": int(b), "s": float(c), "generation": d,
                  "resp_round": e} for a, b, c, d, e in _PS_PARKED.findall(ps_log)]
    trainers = {"w0", "w2"}
    after = [p for p in rec["progress"] if p["t"] > restart_t and p["peer"] in trainers]
    bcast4 = [b for b in rec["broadcast"] if b["round"] == 4]
    return dict(
        kill_to_restart_s=restart_t - kill_t,
        restart_to_last_ack_s=(max(a["t"] for a in acks) - restart_t) if acks else None,
        acks=acks, recoveries=recoveries,
        adopted=forward and {"acked": int(forward.group(1)), "asked": int(forward.group(2)),
                             "journal_round": int(forward.group(3)),
                             "round": int(forward.group(4))},
        journal_records=len(journal), journal_bytes=sum(n for _, n in journal),
        journal_left=extra.get("sched_journal_left"), counts=extra.get("sched_counts"),
        outage_missing=extra.get("outage_missing") or [],
        auctions_after_kill=[a for a in rec["auctions"] if a["t0"] > kill_t],
        dispatches_after_kill=[d for d in rec["dispatch"] if d["t"] > kill_t],
        round4_broadcast=[{"t0": b["t0"], "t1": b["t0"] + b["s"], "to": b["to"]} for b in bcast4],
        round_walls_s={r: walls[r] for r in sorted(walls)},
        added_wall_s=(walls[4] - min(base)) if 4 in walls and base else None,
        added_wall_bound_s=(max(base) + FT_RESTART_BUDGET_S) if base else None,
        parked=parked, ps_parked=ps_parked,
        responses_after_restart=[(p["peer"], p["kind"], p["answer"], p["generation"],
                                  p["resp_round"], p["sched_round"]) for p in after],
        stale_dropped_trainers=sum("stale scheduler generation" in line
                                   for lines in trainer_logs(run).values() for line in lines),
        stale_dropped_ps=ps_log.count("answered by stale scheduler generation"),
    )


def scheduler_figures(s: "dict | None") -> "dict | None":
    """The phase line's figures of the scheduler's kill and restart."""
    if s is None:
        return None
    return {k: s[k] for k in ("kill_to_restart_s", "restart_to_last_ack_s", "adopted",
                              "round_walls_s", "added_wall_s", "added_wall_bound_s",
                              "journal_records", "journal_bytes", "ps_parked", "counts")} | {
        "acks": [(a["peer"], a["state"], a["round"]) for a in s["acks"]],
        "parked": {p["peer"]: p["attempts"] for p in s["parked"]},
        "parked_s": {p["peer"]: p["s"] for p in s["parked"]},
        "responses_after_restart": len(s["responses_after_restart"]),
    }


def scheduler_problems(run: dict, rep: dict, *, rounds: int) -> list:
    """The gates of the scheduler's kill and restart (``scheduler_report``)."""
    s = rep["scheduler"]
    if s is None:
        return ["the scheduler was never killed and restarted"]
    problems = list(s["outage_missing"])
    if s["recoveries"] != [2] or (s["counts"] or {}).get("scheduler_recoveries") != 1:
        problems.append(f"recoveries {s['recoveries']} (counts {s['counts']}): wanted exactly one, "
                        "at generation 2")
    acked = {a["peer"] for a in s["acks"] if a["state"] == "running"}
    deadline = (run["job"].ft.scheduler_adopt_deadline_s or 20.0)
    if acked != {"w0", "w2", "psw"} or len(s["acks"]) != 3 or s["restart_to_last_ack_s"] is None \
            or s["restart_to_last_ack_s"] > deadline:
        problems.append(f"AdoptAcks {s['acks']} ({s['restart_to_last_ack_s']} s after the "
                        f"restart): wanted w0, w2 and psw running within {deadline} s")
    if s["auctions_after_kill"] or s["dispatches_after_kill"]:
        problems.append(f"auctions {s['auctions_after_kill']} and dispatches "
                        f"{s['dispatches_after_kill']} after the kill: wanted none")
    kill_t, restart_t = run["extra"]["sched_kill_t"], run["extra"]["sched_restart_t"]
    b4 = s["round4_broadcast"]
    if len(b4) != 1 or not (kill_t < b4[0]["t0"] and b4[0]["t1"] < restart_t):
        problems.append(f"round 4's broadcast {b4}: wanted one, between the kill ({kill_t}) and "
                        f"the restart ({restart_t})")
    want_round = min(5, rounds)
    if not s["adopted"] or s["adopted"]["round"] != want_round \
            or s["adopted"]["journal_round"] != 4:
        problems.append(f"adoption {s['adopted']}: wanted the journal's round 4 fast-forwarded "
                        f"to {want_round}")
    r4 = collections.Counter(f["peer"] for f in rep["folds"] if f["round"] == 4)
    if sorted(r4.items()) != [("w0", 1), ("w2", 1)] or any(
            h["round"] == 4 for h in rep["dedup_hits"]):
        problems.append(f"round 4 folds {dict(r4)}, dedup hits {rep['dedup_hits']}: wanted two "
                        "folds and no dedup hit")
    bad = [r for r in s["responses_after_restart"] if r[3] != 2 or r[4] != r[5]]
    if not s["responses_after_restart"] or bad:
        problems.append(f"responses to the trainers after the restart {bad or 'none'}: wanted "
                        "each stamped with generation 2 and its round")
    if s["stale_dropped_trainers"] or s["stale_dropped_ps"] or \
            (s["counts"] or {}).get("stale_generation_dropped"):
        problems.append(f"stale-generation drops: trainers {s['stale_dropped_trainers']}, server "
                        f"{s['stale_dropped_ps']}, scheduler {s['counts']}")
    answered = {p["peer"] for p in s["parked"]
                if p["kind"] == "update-received" and p["generation"] == "2"}
    if answered != {"w0", "w2"} or not s["ps_parked"] or s["ps_parked"][0]["generation"] != "2":
        problems.append(f"parked sends {s['parked']}, the server's {s['ps_parked']}: wanted both "
                        "trainers' UPDATE_RECEIVED and the server's UPDATED answered by "
                        "generation 2")
    theta = rep["theta"]
    if theta is not None and theta["broadcast_rounds"] != list(range(rounds)):
        problems.append(f"θ track over broadcast rounds {theta['broadcast_rounds']}: wanted each "
                        f"of {rounds} once")
    if s["journal_left"] or not s["journal_records"]:
        problems.append(f"scheduler journal: {s['journal_records']} records, left after DONE "
                        f"{s['journal_left']}")
    return problems


def ft_problems(run: dict, rep: dict, *, rounds: int, steps: int, layers: int,
                device: str) -> list:
    """The gates of the fault-tolerant job, on the CPU as on the card."""
    from hypha_tpu_torch.executor.checkpoint import latest_manifest

    result, problems = run["result"], []
    if not run["finished"] or result.rounds != rounds or result.attempt != 0:
        problems.append(f"job: finished {run['finished']}, rounds {result.rounds} of {rounds}, "
                        f"attempt {result.attempt} (wanted 0)")
    if rep["updated"] != list(range(rounds)):
        problems.append(f"UPDATED rounds {rep['updated']}, wanted each of {rounds} once")
    for key in ("w0", "w2", "aggregate"):
        states = run["jobs"].get(key) or []
        if not states or states[-1] != "completed":
            problems.append(f"{key}: job states {states}, wanted completed last")
    r0 = [c for c in rep["collects"] if c["round"] == 0]
    r1 = [c for c in rep["collects"] if c["round"] == 1]
    if len(r0) != 1 or r0[0]["peers"] != ["w0", "w1"]:
        problems.append(f"round 0 collected {r0}, wanted w0's and w1's deltas")
    if len(r1) != 1 or r1[0]["peers"] != ["w0"]:
        problems.append(f"round 1 collected {r1}, wanted w0's delta alone")
    absent = [d for d in rep["degraded"] if d[0] == "1" and "w1" in d[3]] or \
        [q for q in rep["quorum_drops"] if q[0] == "1" and "w1" in q[1]]
    if not absent:
        problems.append(f"w1's absence in round 1 not logged: degraded {rep['degraded']}, "
                        f"quorum drops {rep['quorum_drops']}")
    if rep["rejoins"] != [("w2", "w1")] or not rep["catchup"] or rep["catchup"][0]["peer"] != "w2":
        problems.append(f"rejoins {rep['rejoins']}, catch-ups {rep['catchup']}: wanted w2 for w1")
    w0, w2 = rep["trainers"].get("w0", {}), rep["trainers"].get("w2", {})
    if sorted(dict(w0.get("checksums") or [])) != list(range(1, rounds + 1)):
        problems.append(f"w0's anchor checksums {w0.get('checksums')}: wanted rounds 1-{rounds}")
    theta = rep["theta"]
    if theta is not None:
        rejoin = w2.get("rejoin")
        w2_sums = dict(w2.get("checksums") or [])
        cat = theta["catchups"][0] if theta["catchups"] else None
        if rejoin is None or cat is None or not cat["sum_equal"] \
                or cat["rounds"] != rejoin["round"] \
                or cat["broadcast_rounds"] != list(range(rejoin["round"])) \
                or w2_sums.get(rejoin["round"]) != cat["checksum"]:
            problems.append(f"w2's θ after the catch-up {w2_sums} (rejoin {rejoin}) is not θ₀ + "
                            f"Σ of the broadcast updates {cat}")
    if rep["generations"] != [1, 2] or rep["ps_restarts"] != ["psw"]:
        problems.append(f"server generations {rep['generations']}, restarts {rep['ps_restarts']}")
    r2 = [w for w in rep["wires"] if w["round"] == 2]
    if len(r2) != 2 or [w["generation"] for w in r2] != [1, 2] or r2[0]["sha256"] != r2[1]["sha256"]:
        problems.append(f"round 2's wire before and after the replay: {r2}")
    if not rep["replay"] or rep["replay"]["replayed"] != 1 or rep["replay"]["resumes"] != 3:
        problems.append(f"recovery {rep['replay']}, wanted round 2 replayed and round 3 resumed")
    r3 = collections.Counter(f["peer"] for f in rep["folds"] if f["round"] == 3)
    if sorted(r3.items()) != [("w0", 1), ("w2", 1)] or not any(
            h["round"] == 3 and h["generation"] == 2 for h in rep["dedup_hits"]):
        problems.append(f"round 3 journaled folds {dict(r3)}, dedup hits {rep['dedup_hits']}: "
                        "wanted each worker once and a re-send deduplicated")
    for peer, start in (("w0", 0), ("w2", rep["catchup"][0]["round"] if rep["catchup"] else 1)):
        want = [f"v{r:08d}" for r in range(start + 1, rounds + 1)
                if r % FT_CKPT_EVERY == 0][-2:]
        got = sorted(p.name.split("-")[0] for p in (run["ckpt"] / peer).glob("v*"))
        manifest = latest_manifest(run["ckpt"] / peer)
        if got != want or manifest is None or f"v{manifest['round']:08d}" != want[-1]:
            problems.append(f"{peer}: checkpoint versions {got}, latest {manifest}; wanted {want}")
    want_launch = {"fwd": 2 * layers, "dq": layers, "dkv": layers}
    for peer in ("w0", "w2"):
        t = rep["trainers"].get(peer, {})
        n = t.get("batches") or 0
        want = {k: v * n for k, v in want_launch.items()} | {"flash_plain": 0, "dense": 0}
        if device != "cuda":
            want = {"fwd": 0, "dq": 0, "dkv": 0, "flash_plain": 0, "dense": layers * n}
        if not n or t.get("launches") != want:
            problems.append(f"{peer}: attention launches {t.get('launches')}, wanted {want} for "
                            f"{n} batches")
    if run["leftover"] or run["stop_errors"]:
        problems.append(f"files left {run['leftover']}, stop errors {run['stop_errors']}")
    return problems + scheduler_problems(run, rep, rounds=rounds)


def ft_bytes_needed(model: dict) -> int:
    """The disk ``train_ft`` holds at its peak: each trainer's two
    checkpoint versions and one being staged (params, m, v in f32: 12
    bytes a parameter), the server's state file (momentum, Σ, residual),
    its momentum copy, and some int8 deltas and wires."""
    from hypha_tpu_torch.models.registry import build_model

    shapes, _ = build_model(model, device="meta")
    n = sum(p.numel() for p in shapes.parameters())
    return 12 * n * (2 * 2 + 1) + 12 * n + 4 * n + 8 * n


def train_ft_phase() -> dict:
    """Fault-tolerant blocking DiLoCo on the card (``run_ft_job``): a
    killed worker replaced through the catch-up, a killed parameter server
    restarted under its peer id from its journal, trainer checkpoints; held
    to ``ft_problems``."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="hft"))
    try:
        await_removals()
        need = ft_bytes_needed(FT_MODEL)
        free = shutil.disk_usage(root).free
        if free < need:
            raise SystemExit(f"train_ft phase failed: {root} has {free / 1e9:.1f} GB free, the "
                             f"phase needs about {need / 1e9:.1f} GB for its checkpoints")
        run = asyncio.run(run_ft_job(
            root, FT_MODEL, device="cuda", rounds=FT_ROUNDS, steps=FT_STEPS, batch=TRAIN_BATCH,
            seq=TRAIN_SEQ, period=TRAIN_PERIOD, status_timeout=NODE_STATUS_TIMEOUT_S,
            sample_card=True))
        rep = ft_report(run)
        problems = ft_problems(run, rep, rounds=FT_ROUNDS, steps=FT_STEPS, layers=FT_LAYERS,
                               device="cuda")
    finally:
        remove_later(root)
    timing = progress_timing(run | {"workers": ["w0", "w2"]})
    res = dict(
        model="llama2-7b", layers=FT_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
        rounds=FT_ROUNDS, steps=FT_STEPS, chaos=FT_CHAOS, deadline_s=FT_DEADLINE_S,
        attempt=run["result"].attempt, membership=run["result"].ft, jobs=run["jobs"],
        round_boundary_s=timing["round_boundary_s"], step_ms=timing["step_ms"],
        progress_gap_max_s=timing["progress_gap_max_s"],
        disk_needed_gb=need / 1e9, card_peak_gib=(run["card_peak_mib"] or 0) / 1024,
        job_s=run["extra"].get("job_s"), seconds=time.perf_counter() - t0,
        **{k: v for k, v in rep.items() if k not in ("folds", "wires", "trainers", "scheduler")},
        trainers={peer: {k: t[k] for k in ("rejoin", "checkpoints", "launches", "peak_gib",
                                           "batches")} for peer, t in rep["trainers"].items()},
        wires=rep["wires"], folds_round3=[f for f in rep["folds"] if f["round"] == 3],
        scheduler=scheduler_figures(rep["scheduler"]),
    )
    if problems:
        emit({"phase": "train_ft", **res, "problems": problems,
              "logs": {k: v[-60:] for k, v in run["logs"].items()},
              "trainer_logs": {k: v[-40:] for k, v in trainer_logs(run).items()}})
        raise SystemExit("train_ft phase failed: " + "; ".join(problems))
    return res


# ---------------------------------------------------------------------------
# train_shard: two parameter-server shards and a group reducer
# ---------------------------------------------------------------------------

# Job S: stream sync over 2 shards with one reduce group of the 3 workers
# (w0 its reducer; G = 2 would leave a shard's ingress unchanged, since the
# reducer also pushes its own delta directly). One layer: three trainers,
# the stream residuals, two shards and the reducer share the card.
SHARD_S_LAYERS, SHARD_S_WORKERS = 1, 3
SHARD_S_MODEL = {**TRAIN_MODEL, "config": {**TRAIN_MODEL["config"], "num_layers": SHARD_S_LAYERS}}
SHARD_S_OPTIONS = {"sync_mode": "stream", "num_fragments": 4, "delta_codec": "int8",
                   "num_ps_shards": 2, "reduce_group_size": 3}
SHARD_S_ROUNDS = 2  # a round on each shard (4 until train_shard_ft joined the smoke)
# Job B: blocking sync over 2 shards, no group, 1 layer as train_ft.
SHARD_B_LAYERS, SHARD_B_WORKERS = 1, 2  # 2 layers before train_swap joined the smoke
SHARD_B_MODEL = {**TRAIN_MODEL, "config": {**TRAIN_MODEL["config"], "num_layers": SHARD_B_LAYERS}}
SHARD_B_OPTIONS = {"num_ps_shards": 2, "delta_codec": "int8"}
SHARD_B_ROUNDS, SHARD_B_STEPS = 2, 2  # 4 steps until train_shard_ft joined the smoke


@contextmanager
def reducer_probes(rec: dict):
    """The group reducers of the run (``rec["reducers"]``), and for each
    partial a reducer encodes, its f32 sum on its device held bit for bit
    against the harness's own ``RoundAccum`` on the CPU, which folds the
    same files with the same weights and signs in the same order
    (``rec["partial_checks"]``)."""
    from hypha_tpu_torch.stream.accum import RoundAccum
    from hypha_tpu_torch.stream.reduce import GroupReducer

    rec["reducers"], rec["partial_checks"] = [], []
    start, fold, encode = GroupReducer.start, GroupReducer._fold, GroupReducer._encode

    def noted_start(self):
        rec["reducers"].append(self)
        return start(self)

    async def mirrored_fold(self, bucket, path, samples, sign, prefolded):
        await fold(self, bucket, path, samples, sign, prefolded)
        if not hasattr(bucket, "harness"):
            bucket.harness = RoundAccum(device="cpu")
        await asyncio.to_thread(bucket.harness.fold, path, samples, sign, prefolded)

    def checked_encode(self, wire, part, bucket, tag_header):
        card, cpu = bucket.accum.partial(), bucket.harness.partial()
        equal = set(card) == set(cpu) and all(torch.equal(card[k].cpu(), cpu[k]) for k in cpu)
        rec["partial_checks"].append({
            "part": part, "flush": bucket.flushed, "equal": equal,
            "samples": [bucket.accum.total_samples, bucket.harness.total_samples],
            "elements": sum(v.numel() for v in cpu.values())})
        return encode(self, wire, part, bucket, tag_header)

    GroupReducer.start, GroupReducer._fold, GroupReducer._encode = \
        noted_start, mirrored_fold, checked_encode
    try:
        yield rec
    finally:
        GroupReducer.start, GroupReducer._fold, GroupReducer._encode = start, fold, encode


def shard_report(run: dict) -> dict:
    """Per shard and round: the pushes each server saved (direct deltas by
    sender, partials with their covers), bytes, fold s (un-folds included),
    ``outer_step`` s and encode s; the reducer's flushes; each trainer's
    launches, peak, flights and blocking merges; the broadcasts."""
    rec = run["rec"]
    by_path = {d["path"]: d for d in rec["deltas"]}
    shard_of_dir = {str(Path(d["path"]).parent): int(d["header"].get("shard", 0))
                    for d in rec["deltas"]}
    cells: dict = {}

    def cell(k: int, r: int) -> dict:
        return cells.setdefault((k, r), {"shard": k, "round": r, "pushes": 0, "bytes": 0,
                                         "direct": [], "partials": [], "fold_s": 0.0,
                                         "outer_step_s": None, "encode_s": None})

    for d in rec["deltas"]:
        c, h = cell(int(d["header"].get("shard", 0)), d["round"]), d["header"]
        c["pushes"] += 1
        c["bytes"] += d["bytes"]
        if h.get("prefold"):
            c["partials"].append({"from": d["from"], "covers": h.get("covers"),
                                  "bytes": d["bytes"], "samples": h.get("num_samples")})
        else:
            c["direct"].append(d["from"])
    for f in rec["fold_files"]:
        d = by_path.get(f["path"])
        if d is not None:
            cell(int(d["header"].get("shard", 0)), d["round"])["fold_s"] += f["s"]
    for key, what in (("outer_step_s", "outer_steps"), ("encode_s", "encodes")):
        for o in rec[what]:
            if o["work_dir"] in shard_of_dir:
                cell(shard_of_dir[o["work_dir"]], o["round"])[key] = o["s"]
    trainers: dict = {}
    for peer, lines in trainer_logs(run).items():
        text = "\n".join(lines)
        t = trainer_log(text)
        merges = [int(r) for r in re.findall(r"round (\d+) fragment \d+: update merged", text)]
        landed = [(int(r), int(p), int(k)) for r, p, k in
                  re.findall(r"round (\d+): part (\d+) update landed \(shard (\d+)\)", text)]
        blocking = [(int(r), float(s), int(n)) for r, s, n in
                    re.findall(r"round (\d+): update merged in ([\d.]+) s \((\d+) parts\)", text)]
        trainers[peer] = {"launches": t["launches"], "peak_gib": t["peak_gib"],
                          "batches": t["batches"], "flights": t["flights"],
                          "stream_merges": merges, "parts_landed": landed,
                          "blocking_merges": blocking}
    reducers = [{"peer": r.node.peer_id, "members": sorted(r.members), "folds": r.folds,
                 "unfolds": r.unfolds, "partials": r.partials, "flushes": r.flushes}
                for r in rec.get("reducers", [])]
    return {"per_shard_round": [cells[k] for k in sorted(cells)], "reducers": reducers,
            "partial_checks": rec.get("partial_checks", []), "trainers": trainers,
            "broadcasts": [{"round": b["round"], "header": b["header"], "bytes": b["bytes"],
                            "s": b["s"]} for b in rec["broadcast"]]}


def _shard_common_problems(run: dict, *, rounds: int, workers: int) -> list:
    rec, result = run["rec"], run["result"]
    problems = []
    if not run["finished"] or any(s != ["running", "completed"] for s in run["jobs"].values()):
        problems.append(f"job states {run['jobs']} (a trainer must exit 0 in time)")
    if result.rounds != rounds:
        problems.append(f"JobResult.rounds {result.rounds}, wanted {rounds}")
    if sorted(run["workers"]) != [f"w{i}" for i in range(workers)] \
            or sorted(run["ps_peers"]) != ["psw0", "psw1"]:
        problems.append(f"train jobs on {run['workers']}, shards on {run['ps_peers']}: wanted "
                        "one shard on each of psw0 and psw1")
    for peer in run["workers"]:
        losses = [m.get("loss") for w, _, m in result.metrics if w == peer]
        if (len(losses) != rounds or None in losses
                or not torch.isfinite(torch.tensor(losses, dtype=torch.float64)).all()
                or not losses[-1] < losses[0]):
            problems.append(f"{peer}: round losses {losses}: not finite, or the last not below "
                            "the first")
    if rec["renew_failures"]:
        problems.append(f"lease renewals failed: {rec['renew_failures']}")
    if run["leftover"]:
        problems.append(f"files left behind: {run['leftover']}")
    return problems


def shard_stream_problems(run: dict, rep: dict, *, rounds: int, fragments: int) -> list:
    """Job S's gates: each round's update from the shard owning its
    fragment, which took ``w0``'s delta directly, nothing directly from
    ``w1`` or ``w2``, and ``w0``'s partials, the last covering ``[w1,
    w2]``; the other shard nothing that round; every frame an int8 frame
    tagged as its header; every broadcast stamped with its shard; each
    trainer merging each round once; every partial the reducer encoded
    bit-equal to the harness's CPU fold."""
    from hypha_tpu_torch.stream import shard_of

    rec = run["rec"]
    problems = _shard_common_problems(run, rounds=rounds, workers=SHARD_S_WORKERS)
    owner = {r: shard_of(r % fragments, 2) for r in range(rounds)}
    updated = [(p["round"], p["shard"]) for p in rec["progress"] if p["kind"] == "updated"]
    if updated != [(r, owner[r]) for r in range(rounds)]:
        problems.append(f"UPDATED (round, shard) {updated}, wanted each round once from its owner")
    cells = {(c["shard"], c["round"]): c for c in rep["per_shard_round"]}
    for r in range(rounds):
        c = cells.get((owner[r], r))
        if c is None or c["direct"] != ["w0"] or not c["partials"] \
                or any(p["from"] != "w0" for p in c["partials"]) \
                or c["partials"][-1]["covers"] != ["w1", "w2"] \
                or c["pushes"] != 1 + len(c["partials"]):
            problems.append(f"round {r} at shard {owner[r]}: {c}; wanted w0's delta directly "
                            "and w0's partials, the last covering [w1, w2]")
        if (1 - owner[r], r) in cells:
            problems.append(f"round {r}: shard {1 - owner[r]} took {cells[(1 - owner[r], r)]}")
    for d in rec["deltas"]:
        tag = {"round": d["round"], "fragment_id": d["round"] % fragments,
               "fragments": fragments}
        head = {k: d["header"].get(k) for k in tag}
        frame = d["frame"]
        if frame is None or frame["codec"] != "int8" or frame["tag"] != tag or head != tag:
            problems.append(f"round {d['round']} from {d['from']}: frame {frame and frame['tag']}, "
                            f"header {head}; wanted an int8 frame tagged {tag}")
    heads = sorted((b["header"] for b in rep["broadcasts"]), key=lambda h: h["round"])
    if heads != [{"round": r, "fragment_id": r % fragments, "fragments": fragments,
                  "shard": owner[r]} for r in range(rounds)]:
        problems.append(f"broadcast headers {heads}")
    for peer, t in rep["trainers"].items():
        if t["stream_merges"] != list(range(rounds)):
            problems.append(f"{peer} merged rounds {t['stream_merges']}, wanted each once")
    red = rep["reducers"]
    if len(red) != 1 or red[0]["peer"] != "w0" or red[0]["members"] != ["w1", "w2"]:
        problems.append(f"reducers {[(x['peer'], x['members']) for x in red]}, wanted w0 "
                        "folding w1 and w2")
    # w1 and w2 reached w0: every one of their pushes went [w0, shard] and
    # the reducer folded each (no shard saved one of theirs, above).
    member_pushes = [p for p in rec["push"] if p["from"] in ("w1", "w2")]
    if len(member_pushes) != 2 * rounds or any(p["peers"][0] != "w0" for p in member_pushes):
        problems.append(f"w1/w2 pushes routed {[(p['from'], p['peers']) for p in member_pushes]}")
    if red and red[0]["folds"] - red[0]["unfolds"] < 2 * rounds:
        problems.append(f"the reducer folded {red[0]['folds']} (un-folded {red[0]['unfolds']}), "
                        f"wanted w1's and w2's {2 * rounds}")
    checks = rep["partial_checks"]
    partials = sum(len(c["partials"]) for c in rep["per_shard_round"])
    if not checks or not all(c["equal"] and c["samples"][0] == c["samples"][1] for c in checks) \
            or len(checks) != partials:
        problems.append(f"reducer partials against the harness's CPU fold: {checks} "
                        f"({partials} partials at the shards)")
    return problems


def shard_blocking_problems(run: dict, rep: dict, *, rounds: int, expect: dict) -> list:
    """Job B's gates: each trainer pushes two parts a round, one to each
    shard under ``updates….s0`` / ``.s1`` with ``SHARD_KEY``; the parts
    disjoint and covering every name (``shard_names``); the scheduler
    advancing round r only after UPDATED from both shards; each trainer
    landing both parts and merging them every round."""
    from hypha_tpu_torch.stream import shard_names

    rec = run["rec"]
    problems = _shard_common_problems(run, rounds=rounds, workers=SHARD_B_WORKERS)
    sizes = {n: math.prod(s) for n, (_, s) in expect.items()}
    want = {k: set(shard_names(sizes, 2, 2, k)) for k in (0, 1)}
    if want[0] & want[1] or want[0] | want[1] != set(sizes):
        problems.append("shard_names' parts overlap or miss a tensor")
    for peer in run["workers"]:
        for r in range(rounds):
            mine = [p for p in rec["push"] if p["from"] == peer and p["round"] == r]
            got = sorted((p["resource"].rsplit(".", 1)[-1], p["meta"].get("shard")) for p in mine)
            if got != [("s0", 0), ("s1", 1)]:
                problems.append(f"{peer} round {r} pushed {got}, wanted one part to each shard")
    for d in rec["deltas"]:
        k = int(d["header"].get("shard", -1))
        names = set((d["frame"] or {}).get("tensors") or {})
        if k not in want or names != want[k]:
            problems.append(f"round {d['round']} from {d['from']} at shard {k}: "
                            f"{len(names)} tensors, not part {k}")
    cells = {(c["shard"], c["round"]): c for c in rep["per_shard_round"]}
    for r in range(rounds):
        for k in (0, 1):
            c = cells.get((k, r))
            if c is None or sorted(c["direct"]) != sorted(run["workers"]) or c["partials"]:
                problems.append(f"round {r} at shard {k}: {c}")
    prog = rec["progress"]
    for r in range(rounds):
        adv = next((i for i, p in enumerate(prog) if (p["sched_round"] or 0) > r), None)
        seen = {p["shard"] for p in prog[:(adv + 1) if adv is not None else len(prog)]
                if p["kind"] == "updated" and p["round"] == r}
        if adv is None or prog[adv]["kind"] != "updated" or seen != {0, 1}:
            problems.append(f"round {r} advanced at {adv and prog[adv]} after UPDATED from "
                            f"shards {sorted(seen)}, wanted both")
    for peer, t in rep["trainers"].items():
        landed = sorted((r, p) for r, p, _ in t["parts_landed"])
        merged = [(r, n) for r, _, n in t["blocking_merges"]]
        if landed != [(r, p) for r in range(rounds) for p in (0, 1)] \
                or merged != [(r, 2) for r in range(rounds)]:
            problems.append(f"{peer} landed {landed} and merged {merged}, wanted both parts "
                            "every round")
    heads = sorted((b["header"] or {}).get("shard", -1) for b in rep["broadcasts"])
    if heads != sorted([0, 1] * rounds):
        problems.append(f"broadcast shards {heads}")
    return problems


def shard_launch_problems(rep: dict, layers: int) -> list:
    """Each trainer's flash launches: every batch through the kernels."""
    problems = []
    for peer, t in rep["trainers"].items():
        n = t["batches"] or 0
        want = {"fwd": 2 * layers * n, "dq": layers * n, "dkv": layers * n,
                "flash_plain": 0, "dense": 0}
        if not n or t["launches"] != want:
            problems.append(f"{peer} attention launches {t['launches']}, wanted {want} for {n} "
                            "batches")
    return problems


def shard_bytes_needed(model: dict, trainers: int) -> int:
    """The card's memory a job needs, roughly: each trainer's parameters,
    gradients, Adam moments, anchor and a fragment snapshot in f32 (24
    bytes a parameter) and 3 GiB of activations; the shards' sums and
    residuals and the reducer's buckets and residuals (16 bytes)."""
    from hypha_tpu_torch.models.registry import build_model

    shapes, _ = build_model(model, device="meta")
    n = sum(p.numel() for p in shapes.parameters())
    return trainers * (24 * n + 3 * 2**30) + 16 * n


def _shard_job_summary(run: dict, rep: dict, seconds: float, server_peak: float) -> dict:
    timing = progress_timing(run)
    step_ms = timing["step_ms"]
    return dict(
        jobs=run["jobs"], result_rounds=run["result"].rounds, seconds=seconds,
        updated=[(p["round"], p["shard"]) for p in run["rec"]["progress"]
                 if p["kind"] == "updated"],
        losses=[(w, r, m.get("loss")) for w, r, m in run["result"].metrics],
        step_ms=step_ms, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3) if step_ms else None,
        round_boundary_s=timing["round_boundary_s"],
        progress_gap_max_s=timing["progress_gap_max_s"],
        trainer_peak_gib={p: t["peak_gib"] for p, t in rep["trainers"].items()},
        server_and_reducer_peak_gib=server_peak,
        card_peak_gib=(run["card_peak_mib"] or 0) / 1024,
        attention_launches={p: t["launches"] for p, t in rep["trainers"].items()},
        per_shard_round=rep["per_shard_round"], broadcasts=rep["broadcasts"],
        loop_stall_max_s=run["loop_stall_max_s"], leftover_files=run["leftover"])


def train_shard_phase() -> dict:
    """The sharded parameter service and the tree reduce on the card.
    Job S: ``SHARD_S_OPTIONS`` (stream, int8, 2 shards, one group of 3)
    on three trainer processes, ``SHARD_S_ROUNDS`` x ``STREAM_STEPS``; Job
    B: ``SHARD_B_OPTIONS`` (blocking, int8, 2 shards) on two, held to
    ``shard_stream_problems`` and ``shard_blocking_problems``."""
    from hypha_tpu_torch.executor.serialization import load_file
    from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor as PS

    t0 = time.perf_counter()
    out: dict = {}
    problems: list = []
    captured: dict = {}
    encode = PS._encode_broadcast

    def capture(self, update_path, codec, ef, work_dir, round_num, tag=None):
        if round_num == 0 and not captured:  # a shard's f32 update, for the quantize check
            captured.update(load_file(update_path))
        return encode(self, update_path, codec, ef, work_dir, round_num, tag)

    for job, model, workers, rounds, steps, options in (
            ("S", SHARD_S_MODEL, SHARD_S_WORKERS, SHARD_S_ROUNDS, STREAM_STEPS, SHARD_S_OPTIONS),
            ("B", SHARD_B_MODEL, SHARD_B_WORKERS, SHARD_B_ROUNDS, SHARD_B_STEPS,
             SHARD_B_OPTIONS)):
        gc.collect()
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0]
        need = shard_bytes_needed(model, workers)
        if free < need:
            raise SystemExit(f"train_shard phase failed: job {job} needs about "
                             f"{need / 2**30:.1f} GiB of the card for {workers} trainers, two "
                             f"shards and the reducer; {free / 2**30:.1f} GiB are free")
        root = Path(tempfile.mkdtemp(prefix=f"hsh{job}"))
        torch.cuda.reset_peak_memory_stats()
        PS._encode_broadcast = capture
        t_job = time.perf_counter()
        try:
            run = asyncio.run(run_node_job(
                root, model, device="cuda", rounds=rounds, steps=steps, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, period=TRAIN_PERIOD, workers=workers, ps_hosts=2,
                status_timeout=NODE_STATUS_TIMEOUT_S, job_options=options,
                check_reducer=job == "S", sample_card=True))
        finally:
            PS._encode_broadcast = encode
            shutil.rmtree(root, ignore_errors=True)
        seconds = time.perf_counter() - t_job
        rep = shard_report(run)
        layers = model["config"]["num_layers"]
        if job == "S":
            found = shard_stream_problems(run, rep, rounds=rounds,
                                          fragments=options["num_fragments"])
        else:
            found = shard_blocking_problems(run, rep, rounds=rounds, expect=flat_f32_spec(model))
        found += shard_launch_problems(rep, layers)
        summary = _shard_job_summary(run, rep, seconds,
                                     torch.cuda.max_memory_allocated() / 2**30)
        summary.update(model="llama2-7b", layers=layers, workers=workers, rounds=rounds,
                       steps_a_round=steps, options=options, need_gib=need / 2**30,
                       free_gib=free / 2**30)
        if job == "S":
            red = rep["reducers"][0] if rep["reducers"] else {}
            flushes = red.get("flushes", [])
            per_round = collections.Counter(f["round"] for f in flushes)
            summary.update(
                reducer={k: red.get(k) for k in ("peer", "members", "folds", "unfolds",
                                                 "partials")},
                reducer_flushes=[{k: f[k] for k in ("round", "part", "flush", "covers", "bytes",
                                                    "fold_s", "encode_s", "push_s")}
                                 for f in flushes],
                reflushes={r: per_round[r] - 1 for r in range(rounds)},
                partial_checks=rep["partial_checks"],
                flights={p: t["flights"] for p, t in rep["trainers"].items()},
                quantize_check=quantize_check(captured))
            captured.clear()
            if summary["quantize_check"]["mismatched"] or not summary["quantize_check"]["tensors"]:
                found.append(f"the card's quantize differs from the CPU's: "
                             f"{summary['quantize_check']}")
        out[f"job_{job}"] = summary
        if found:
            problems += [f"job {job}: {p}" for p in found]
            emit({"phase": "train_shard", "job": job, **summary, "problems": found,
                  "trainer_logs": {k: v[-40:] for k, v in trainer_logs(run).items()}})
            break
    res = {**out, "seconds": time.perf_counter() - t0}
    if problems:
        raise SystemExit("train_shard phase failed: " + "; ".join(problems))
    return res


# ---------------------------------------------------------------------------
# train_shard_ft: fault tolerance of a streaming, sharded, tree-reduced job
# ---------------------------------------------------------------------------

# Job S of train_shard (stream F=4, int8, two shards, one group of 3 with
# w0 its reducer) made fault tolerant: elastic rounds, durable shards
# checkpointed every SHARD_FT_PS_EVERY of their own commits, a shard
# restart, and trainer checkpoints every SHARD_FT_EVERY rounds (the last:
# three trainers' 5.6 GB versions cost the disk's write-back time). 4
# rounds (6 before tracing joined the smoke): the faults fall in rounds 1-3.
SHARD_FT_ROUNDS = 4
SHARD_FT_EVERY = 4
SHARD_FT_PS_EVERY = 2
SHARD_FT_DEADLINE_S = 70.0
SHARD_FT_CHAOS = "kill-worker:1,kill-ps:3"
SHARD_FT_FLUSH_S = 2.0  # the group reducer's flush timer (5 s by default)


def shard_ft_job(model: dict, *, rounds, steps, batch, lr, deadline_s, checkpoint_dir):
    """``node_job`` for Job S of ``train_shard`` with ``ft`` (quorum 0.5,
    one shard restart; its auction window, 20 backoffs, outlasts the
    shard's outage) and durable shards and trainer checkpoints under
    ``checkpoint_dir``."""
    from hypha_tpu_torch.ft import FTConfig

    return node_job(model, rounds=rounds, steps=steps, batch=batch, lr=lr,
                    workers=SHARD_S_WORKERS, **SHARD_S_OPTIONS,
                    ft=FTConfig(quorum_fraction=0.5, round_deadline_s=deadline_s,
                                rejoin_attempts=60, rejoin_backoff_s=1.0,
                                ps_restart_attempts=1, ps_restart_backoff_s=5.0),
                    checkpoint_dir=str(checkpoint_dir), checkpoint_every=SHARD_FT_EVERY,
                    ps_checkpoint_every_rounds=SHARD_FT_PS_EVERY)


async def run_shard_ft_job(root: Path, model: dict, *, device, rounds, steps, batch, seq,
                           period, lr=3e-4, deadline_s=SHARD_FT_DEADLINE_S, limit_s=CLI_LIMIT_S,
                           train_runtime="process", auction_timeout=2.0, status_timeout=None,
                           sample_card=False) -> dict:
    """``shard_ft_job`` on the port's nodes at 127.0.0.1: gateway, data
    node, train workers ``w0``-``w2`` (``w0`` reduces the group), the two
    shards on ``psw0`` and ``psw1`` (the auction places them; shard 0 closes
    the even rounds, shard 1 the odd ones), the port's ``Orchestrator``,
    and a ``ChaosController`` on ``SHARD_FT_CHAOS``:

      * ``kill-worker:1`` — ``w2``, a group member, is killed once shard 1
        journaled round 1's partial covering it; a spare ``w3`` starts once
        the kill finished and round 1 closed, and the scheduler's rejoin
        has each shard serve it a catch-up (shard 0 at round 2, shard 1 at
        round 3): it enters round 2 with θ₀ + Σ of rounds 0 and 1;
      * ``kill-ps:3`` — shard 1's host is killed once both catch-ups were
        served, after it committed round 1 (not yet checkpointed: the
        restart replays it, the reducer's partial included) and while it
        waits for round 3, its next. Shard 0 closes round 2 during the
        outage; a new node under the killed host's peer id starts only
        after that round's ``UPDATED``, and the scheduler re-dispatches
        shard 1's job to it alone.

    A shard killed in the middle of its own round would stall every round
    after it (a worker ships round r+1 only after merging round r), so the
    other shard could close none during the outage. Round 2's pushes wait
    (``_gated_push``) until the rejoin is dispatched, so the catch-ups come
    at round 2 on every run. Returns what ``node_probes`` and
    ``ft_probes`` saw, the logs, the chaos and restart times, the disk use
    before and after, the checkpoint tree and the files left outside it."""
    import logging

    from hypha_tpu_torch import aio
    from hypha_tpu_torch.data_node import DataNode
    from hypha_tpu_torch.ft import ChaosController, parse_chaos_specs
    from hypha_tpu_torch.gateway import Gateway
    from hypha_tpu_torch.network import Node, TcpTransport
    from hypha_tpu_torch.resources import Resources
    from hypha_tpu_torch.scheduler.orchestrator import Orchestrator
    from hypha_tpu_torch.stream.reduce import REDUCE_FLUSH_ENV
    from hypha_tpu_torch.worker.arbiter import OfferConfig
    from hypha_tpu_torch.worker.runtime import WorkerNode

    disk_before = shutil.disk_usage(root)
    data_dir, ckpt = root / "data", root / "ckpt"
    data_dir.mkdir(parents=True)
    write_slices(data_dir, n_slices=4, per_slice=rounds * steps * batch, seq=seq, period=period,
                 seed=5)
    job = shard_ft_job(model, rounds=rounds, steps=steps, batch=batch, lr=lr,
                       deadline_s=deadline_s, checkpoint_dir=ckpt)
    theta = ThetaTrack(model, device)
    listen = ["127.0.0.1:0"]

    def worker(name: str) -> "WorkerNode":
        return WorkerNode(TcpTransport(), resources=Resources(gpu=1, cpu=8, memory=65536),
                          device=device, peer_id=name, train_runtime=train_runtime,
                          offer=OfferConfig(strategy="whole"), bootstrap=boot,
                          work_root=root / name)

    def server(name: str, work: str) -> "WorkerNode":
        return WorkerNode(TcpTransport(), resources=Resources(cpu=8, memory=65536), device=device,
                          peer_id=name, bootstrap=boot, work_root=root / work)

    gw = Gateway(TcpTransport(), peer_id="gw")
    await gw.start(listen)
    boot = [gw.node.listen_addrs[0]]
    data = DataNode(TcpTransport(), {NODE_DATASET: data_dir}, peer_id="data", bootstrap=boot)
    workers = [worker(f"w{i}") for i in range(SHARD_S_WORKERS)]
    shards = [server("psw0", "ps0"), server("psw1", "ps1")]
    node = Node(TcpTransport(), peer_id="sched", bootstrap=boot)
    # The auction places the shards: kill-ps's target, the host of shard 1,
    # is known at its dispatch.
    actions = parse_chaos_specs(SHARD_FT_CHAOS, "w2")
    chaos = ChaosController(actions, {"w2": workers[2], **{s.peer_id: s for s in shards}},
                            clock=time.perf_counter)
    joined = asyncio.Event()

    async def after_join(_peer: str) -> None:
        await joined.wait()

    gates = {2: after_join}

    def on_fold(round_num: int, key: str, covers=None) -> None:
        # w2's kill: round 1's delta from it is in shard 1's journal, inside
        # the reducer's partial or (failed over) on its own.
        if round_num == 1 and (key == "w2" or "w2" in (covers or [])):
            chaos.on_round_metrics(0)

    logs: dict = {"ps": [], "sched": []}

    class Lines(logging.Handler):
        def __init__(self, key):
            super().__init__()
            self.key = key

        def emit(self, record):
            logs[self.key].append(f"{time.perf_counter():.3f} {record.getMessage()}")

    handlers = [(logging.getLogger(n), Lines(k)) for n, k in (
        ("hypha.torch.worker.ps", "ps"), ("hypha.torch.ft.durable", "ps"),
        ("hypha.torch.scheduler.orchestrator", "sched"))]
    levels = [lg.level for lg, _ in handlers]
    for lg, h in handlers:
        lg.addHandler(h)
        lg.setLevel(logging.INFO)
    started: list = []
    stop_errors: list = []
    extra: dict = {}
    stalls: list = []
    peak = [0.0]
    sampling = asyncio.Event()
    tasks = [asyncio.create_task(watch_loop(stalls))]
    if sample_card:
        tasks.append(asyncio.create_task(_device_mem_sampler(peak, sampling)))

    def updated(rec, round_num: int) -> bool:
        return any(p["kind"] == "updated" and p["round"] == round_num for p in rec["progress"])

    hosts: dict = {}  # shard -> the peer its job was dispatched to

    async def restarter(rec) -> None:
        """The spare worker after w2's kill and round 1's close; shard 1's
        kill once both shards served the rejoiner; its new node after
        round 2."""
        while chaos.fired_at("w2") is None:
            await asyncio.sleep(0.05)
        await chaos.drain()
        extra["w2_dead_t"] = time.perf_counter()
        while not updated(rec, 1):
            await asyncio.sleep(0.05)
        w3 = worker("w3")
        await w3.start(listen)
        started.append(w3)
        extra["w3_up_t"] = time.perf_counter()
        while not rec["rejoins"]:
            await asyncio.sleep(0.05)
        joined.set()
        while sum("served catch-up" in line and "rejoiner w3" in line
                  for line in logs["ps"]) < 2:
            await asyncio.sleep(0.05)
        for d in rec["dispatch"]:
            if d["kind"] == "aggregate":
                hosts[int(d["job_id"].rsplit("-ps", 1)[1])] = d["peer"]
        for a in actions:
            a.target = hosts[1] if a.kind == "kill-ps" else "w2"
        chaos.on_round_metrics(2)  # kill-ps:3: shard 1 waits for round 3
        await chaos.drain()
        extra["psw1_dead_t"] = time.perf_counter()
        while not updated(rec, 2):
            await asyncio.sleep(0.05)
        extra["round2_updated_t"] = time.perf_counter()
        # The gateway drops a closed peer's registrations by peer id: a
        # node started under the same id before it noticed would lose its
        # own.
        await asyncio.sleep(1.0)
        revived = server(hosts[1], f"{hosts[1]}b")
        await revived.start(listen)
        started.append(revived)
        extra["psw1b_up_t"] = time.perf_counter()

    # After w2's death its reducer flushes each round on the timer alone:
    # 2 s (the trainers reach their sync point within it) keeps the four
    # rounds after it inside the smoke's time limit.
    flush_env = os.environ.get(REDUCE_FLUSH_ENV)
    os.environ[REDUCE_FLUSH_ENV] = str(SHARD_FT_FLUSH_S)
    with node_probes(device) as rec, ft_probes(rec, theta, on_fold, lambda: None, shards=2):
        restart = None
        try:
            for part in (data, *workers, *shards, node):
                await part.start(listen)
                started.append(part)
            for w in workers:
                _gated_push(w.node, gates)
            await node.wait_for_bootstrap()
            restart = asyncio.create_task(restarter(rec))
            t_job = time.perf_counter()
            result = await Orchestrator(node).run(
                job, auction_timeout=auction_timeout, status_timeout=status_timeout)
            extra["job_s"] = time.perf_counter() - t_job
            final = {"completed", "failed", "cancelled"}
            loop = asyncio.get_running_loop()
            deadline = loop.time() + limit_s
            while True:
                live = {d["job_id"] for d in rec["dispatch"] if d["peer"] != "w2"}
                ended = {s["job_id"] for s in rec["statuses"] if s["state"] in final}
                finished = live <= ended
                if finished or loop.time() > deadline:
                    break
                await asyncio.sleep(0.1)
        finally:
            if restart is not None:
                await aio.reap(restart)
            sampling.set()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            for part in reversed(started):
                try:
                    await part.stop()
                except Exception as e:  # noted; shard_ft_problems fails on it
                    stop_errors.append(f"{getattr(part, 'peer_id', part)}: {e!r}")
            await gw.stop()
            for (lg, h), level in zip(handlers, levels):
                lg.removeHandler(h)
                lg.setLevel(level)
            if flush_env is None:
                os.environ.pop(REDUCE_FLUSH_ENV, None)
            else:
                os.environ[REDUCE_FLUSH_ENV] = flush_env
    leftover: list = []
    for _ in range(300):
        leftover = sorted(str(p.relative_to(root)) for p in root.rglob("*")
                          if p.is_file() and not p.is_relative_to(data_dir)
                          and not p.is_relative_to(ckpt))
        if not leftover:
            break
        await asyncio.sleep(0.1)
    tree = sorted((str(p.relative_to(ckpt)), p.stat().st_size) for p in ckpt.rglob("*")
                  if p.is_file())
    jobs: dict = {}
    for d in rec["dispatch"]:
        key = d["peer"] if d["kind"] == "train" else f"aggregate{d['job_id'].rsplit('-', 1)[1]}"
        jobs.setdefault(key, []).extend(
            s["state"] for s in rec["statuses"] if s["job_id"] == d["job_id"])
    return dict(job=job, result=result, rec=rec, finished=finished, logs=logs, theta=theta,
                chaos={a.kind: a.fired_at for a in chaos.fired}, jobs=jobs, extra=extra,
                workers=["w0", "w1", "w3"], shard_hosts=hosts, stop_errors=stop_errors,
                leftover=leftover,
                checkpoints=tree, ckpt=ckpt, disk_before=disk_before,
                disk_after=shutil.disk_usage(root),
                card_peak_mib=peak[0] if sample_card else None,
                loop_stall_max_s=max(stalls, default=0.0))


_RESEND = re.compile(r"stream sync: parameter server restarted; re-sending round (\d+) fragment "
                     r"(\d+)")
_SHARD_CATCHUP = re.compile(r"served catch-up \((\d+) rounds, next (\d+)\) to rejoiner (\S+): "
                            r"(\d+) bytes in ([\d.]+) s \(shard (\d+)\)")
_SHARD_CKPT = re.compile(r"durable ps checkpoint: next_round \d+ -> (\d+) \(\d+ tensors, (\d+) "
                         r"bytes in ([\d.]+) s, journal window \d+ records\) under (\S+)")


def shard_ft_report(run: dict) -> dict:
    """What ``run_shard_ft_job`` measured, per shard, from its stamps and
    the logs."""
    from hypha_tpu_torch.stream import shard_of

    rec, logs = run["rec"], trainer_logs(run)
    ps_log = "\n".join(run["logs"]["ps"])
    fired, extra = run["chaos"], run["extra"]
    per: dict = {}
    for peer, lines in logs.items():
        text = "\n".join(lines)
        t = trainer_log(text)
        rejoin = re.search(r"rejoin: caught up to round (\d+) .*?: (\d+) bytes, waited ([\d.]+) s, "
                           r"merged in ([\d.]+) s", text)
        per[peer] = {
            "launches": t["launches"], "peak_gib": t["peak_gib"], "batches": t["batches"],
            "checksums": [(int(r), c) for r, c in _CHECKSUM.findall(text)],
            "rejoin": rejoin and {"round": int(rejoin.group(1)), "bytes": int(rejoin.group(2)),
                                  "wait_s": float(rejoin.group(3)),
                                  "merge_s": float(rejoin.group(4))},
            "shard_catchups": [(int(k), int(r), int(b)) for k, r, b in re.findall(
                r"rejoin: shard (\d+) catch-up to round (\d+): (\d+) bytes", text)],
            "checkpoints": [{"round": int(r), "version": v, "s": float(s), "bytes": int(b)}
                            for r, v, s, b in _CKPT_SAVE.findall(text)],
            "resends": [(int(r), int(f)) for r, f in _RESEND.findall(text)],
            "stream_merges": [int(r) for r in re.findall(
                r"round (\d+) fragment \d+: update merged", text)],
        }
    deps = {d["peer"]: d["t"] for d in rec["departures"]}
    first_beat: dict = {}
    for p in rec["progress"]:
        if p["kind"] == "status":
            first_beat.setdefault(p["peer"], p["t"])
    upd = [(p["round"], p["shard"], p["t"]) for p in rec["progress"] if p["kind"] == "updated"]
    down, gen2 = fired.get("kill-ps"), [
        b for b in rec["broadcast"] if (b["header"] or {}).get("ps_generation") == 2]
    back = min((b["t0"] for b in gen2), default=None)
    replay = _REPLAY.search(ps_log)
    by_root: dict = {}
    for root, _kind, n in rec["journal_by_root"]:
        acc = by_root.setdefault(root, {"records": 0, "bytes": 0})
        acc["records"] += 1
        acc["bytes"] += n
    pushes: dict = {}
    covers: dict = {}  # each reducer's partials at a shard and round: their covers, in order
    for d in rec["deltas"]:
        k = int(d["header"].get("shard", 0))
        key = (k, d["round"], d["from"], bool(d["header"].get("prefold")))
        pushes[key] = pushes.get(key, 0) + 1
        if key[3]:
            covers.setdefault(f"{k}/{d['round']}/{d['from']}", []).append(
                sorted(d["header"].get("covers") or []))
    return dict(
        trainers=per,
        updated=[(r, k) for r, k, _ in upd],
        updated_t={f"{r}/{k}": t for r, k, t in upd},
        kill_to_departure_s=(deps["w2"] - fired["kill"]) if "w2" in deps and "kill" in fired
        else None,
        departure_to_w3_beat_s=(first_beat["w3"] - deps["w2"]) if "w3" in first_beat
        and "w2" in deps else None,
        catchups=[{"rounds": int(a), "round": int(b), "peer": c, "bytes": int(d), "s": float(e),
                   "shard": int(f)} for a, b, c, d, e, f in _SHARD_CATCHUP.findall(ps_log)],
        shard_kill_t=down, shard_back_t=back,
        shard_kill_to_gen2_broadcast_s=(back - down) if back and down else None,
        other_shard_rounds_in_outage=[(r, k, t - down) for r, k, t in upd
                                      if down and k == 0 and down < t < (back or t + 1)],
        replay=replay and {"generation": int(replay.group(1)), "resumes": int(replay.group(2)),
                           "replayed": int(replay.group(3)), "s": float(replay.group(4))},
        ps_checkpoints=[{"next_round": int(a), "bytes": int(b), "s": float(c), "root": d}
                        for a, b, c, d in _SHARD_CKPT.findall(ps_log)],
        journal_by_root=by_root,
        generations=sorted({int(g) for g in re.findall(r"durable state at \S+, generation (\d+)",
                                                       ps_log)}),
        wires=rec["wires"], folds=rec["folds"], dedup_hits=rec["dedup_hits"],
        pushes_by_shard={f"{k}/{r}/{f}/{'partial' if p else 'direct'}": n
                         for (k, r, f, p), n in sorted(pushes.items())},
        partial_covers=covers,
        departures=[(d["peer"], d["reason"]) for d in rec["departures"]],
        rejoins=[(r["peer"], r["for"]) for r in rec["rejoins"]],
        ps_restarts=re.findall(r"parameter server shard (\d+) restarted on (\S+)",
                               "\n".join(run["logs"]["sched"])),
        theta={"catchups": run["theta"].catchups},
        owner={r: shard_of(r % SHARD_S_OPTIONS["num_fragments"], 2)
               for r in range(SHARD_FT_ROUNDS)},
        disk_free_gb=(run["disk_before"].free / 1e9, run["disk_after"].free / 1e9),
        checkpoint_bytes=sum(n for _, n in run["checkpoints"]),
        outage={k: extra.get(k) for k in ("w2_dead_t", "w3_up_t", "psw1_dead_t",
                                          "round2_updated_t", "psw1b_up_t")},
    )


def shard_ft_problems(run: dict, rep: dict, *, rounds: int, layers: int, device: str) -> list:
    """The gates of the fault-tolerant sharded job, on the CPU as on the
    card."""
    from hypha_tpu_torch.executor.checkpoint import latest_manifest

    result, problems = run["result"], []
    owner = {r: r % 2 for r in range(rounds)}
    if not run["finished"] or result.rounds != rounds or result.attempt != 0:
        problems.append(f"job: finished {run['finished']}, rounds {result.rounds} of {rounds}, "
                        f"attempt {result.attempt} (wanted 0: no full restart)")
    if rep["updated"] != [(r, owner[r]) for r in range(rounds)]:
        problems.append(f"UPDATED (round, shard) {rep['updated']}, wanted each round once from "
                        "its due shard")
    for key in ("w0", "w1", "w3", "aggregateps0", "aggregateps1"):
        states = run["jobs"].get(key) or []
        if not states or states[-1] != "completed":
            problems.append(f"{key}: job states {states}, wanted completed last")
    if [p for p, _ in rep["departures"]] != ["w2"] or rep["rejoins"] != [("w3", "w2")]:
        problems.append(f"departures {rep['departures']}, rejoins {rep['rejoins']}: wanted w3 "
                        "for w2")
    outage = rep["other_shard_rounds_in_outage"]
    if not outage:
        problems.append(f"shard 0 closed no round while shard 1 was down (killed at "
                        f"{rep['shard_kill_t']}, generation 2 at {rep['shard_back_t']}; "
                        f"UPDATED {rep['updated_t']})")
    host = run["shard_hosts"].get(1)
    if rep["generations"] != [1, 2] or rep["ps_restarts"] != [("1", host)]:
        problems.append(f"shard generations {rep['generations']}, restarts {rep['ps_restarts']}: "
                        f"wanted shard 1 restarted once on {host}")
    if not rep["replay"] or rep["replay"]["generation"] != 2 or rep["replay"]["replayed"] < 1:
        problems.append(f"recovery {rep['replay']}: wanted shard 1's committed rounds replayed")
    w1 = [w for w in rep["wires"] if w["root"] == "ps1"]
    replayed = sorted({w["round"] for w in w1 if w["generation"] == 2
                       and w["round"] < (rep["replay"] or {}).get("resumes", 0)})
    for r in replayed:
        pair = [w for w in w1 if w["round"] == r]
        if [w["generation"] for w in pair] != [1, 2] or pair[0]["sha256"] != pair[1]["sha256"]:
            problems.append(f"shard 1 round {r}'s wire before and after the replay: {pair}")
    partial_rounds = {f["round"] for f in rep["folds"] if f["root"] == "ps1" and f["prefold"]
                      and f["covers"] and f["generation"] == 1}
    if not replayed or not partial_rounds & set(replayed):
        problems.append(f"replayed rounds {replayed}, rounds with a journaled partial "
                        f"{sorted(partial_rounds)}: wanted a byte-equal replay of a round with a "
                        "prefold partial")
    resends = {p: t["resends"] for p, t in rep["trainers"].items()}
    if any(r % 2 != 1 for rs in resends.values() for r, _f in rs) or not any(resends.values()):
        problems.append(f"re-sends {resends}: wanted some, each of a round shard 1 owns")
    dup0 = shard0_resends(rep)
    if dup0 or any(h["root"] == "ps0" for h in rep["dedup_hits"]):
        problems.append(f"shard 0 got re-sends: {dup0}, dedup hits {rep['dedup_hits']}")
    cats = rep["theta"]["catchups"]
    w3 = rep["trainers"].get("w3", {})
    rejoin = w3.get("rejoin")
    sums = dict(w3.get("checksums") or [])
    served = sorted((c["shard"], c["peer"]) for c in rep["catchups"])
    if served != [(0, "w3"), (1, "w3")] or len(cats) != 2 \
            or not all(c["sum_equal"] for c in cats) \
            or cats[0]["broadcast_rounds"] != cats[1]["broadcast_rounds"] \
            or set(cats[0]["keys"]) & set(cats[1]["keys"]) \
            or rejoin is None or cats[0]["broadcast_rounds"] != list(range(rejoin["round"])) \
            or sums.get(rejoin["round"]) != cats[0]["checksum"]:
        problems.append(f"w3's θ after its catch-ups {sums} (rejoin {rejoin}, served {served}) is "
                        f"not θ₀ + Σ of the broadcast updates, unioned over both shards: {cats}")
    for peer, start in (("w0", 0), ("w1", 0), ("w3", rejoin["round"] if rejoin else 2)):
        want = [f"v{r:08d}" for r in range(start + 1, rounds + 1)
                if r % SHARD_FT_EVERY == 0][-2:]
        got = sorted(p.name.split("-")[0] for p in (run["ckpt"] / peer).glob("v*"))
        manifest = latest_manifest(run["ckpt"] / peer)
        if got != want or manifest is None or f"v{manifest['round']:08d}" != want[-1]:
            problems.append(f"{peer}: checkpoint versions {got}, latest {manifest}; wanted {want}")
    for peer in ("w0", "w1", "w3"):
        t = rep["trainers"].get(peer, {})
        n = t.get("batches") or 0
        want = {"fwd": 2 * layers * n, "dq": layers * n, "dkv": layers * n,
                "flash_plain": 0, "dense": 0}
        if device != "cuda":
            want = {"fwd": 0, "dq": 0, "dkv": 0, "flash_plain": 0, "dense": layers * n}
        if not n or t.get("launches") != want:
            problems.append(f"{peer}: attention launches {t.get('launches')}, wanted {want} for "
                            f"{n} batches")
    if run["leftover"] or run["stop_errors"]:
        problems.append(f"files left {run['leftover']}, stop errors {run['stop_errors']}")
    return problems


def shard0_resends(rep: dict) -> dict:
    """Shard 0's re-sends in ``shard_ft_report``'s counts, by
    ``shard/round/sender/kind``: a sender's direct delta that came more than
    once, or a reducer's partial whose cover does not strictly contain the
    cover of that reducer's partial before it at the same shard and round (a
    cover repeated, one already folded). A reducer's flush timer can ship a
    partial before every member landed and then its replacement, which
    covers strictly more: that is the reducer's design, not a re-send."""
    bad = {}
    for key, n in rep["pushes_by_shard"].items():
        if not key.startswith("0/") or n <= 1:
            continue
        if key.endswith("/partial"):
            seq = [set(c) for c in rep["partial_covers"].get(key.rsplit("/", 1)[0], [])]
            if len(seq) == n and all(a < b for a, b in zip(seq, seq[1:])):
                continue
        bad[key] = n
    return bad


def shard_ft_bytes_needed(model: dict) -> int:
    """The disk ``train_shard_ft`` holds at its peak: three trainers'
    checkpoints (params, m, v in f32: 12 bytes a parameter), each shard's
    state file twice over (momentum, Σ and residuals in f32 over half the
    parameters) and its momentum copies, and some int8 deltas and wires."""
    from hypha_tpu_torch.models.registry import build_model

    shapes, _ = build_model(model, device="meta")
    n = sum(p.numel() for p in shapes.parameters())
    return 3 * 12 * n + 2 * (2 * 6 * n + 2 * n) + 8 * n


def train_shard_ft_phase() -> dict:
    """Fault tolerance of a streaming, sharded, tree-reduced job on the card
    (``run_shard_ft_job``): a killed group member replaced through one
    catch-up per shard, a killed shard restarted alone under its peer id
    from its own journal while the other closes its round, stream-mode
    trainer checkpoints; held to ``shard_ft_problems``."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="hsf"))
    try:
        await_removals()
        need = shard_ft_bytes_needed(SHARD_S_MODEL)
        free = shutil.disk_usage(root).free
        if free < need:
            raise SystemExit(f"train_shard_ft phase failed: {root} has {free / 1e9:.1f} GB free, "
                             f"the phase needs about {need / 1e9:.1f} GB for its checkpoints")
        run = asyncio.run(run_shard_ft_job(
            root, SHARD_S_MODEL, device="cuda", rounds=SHARD_FT_ROUNDS, steps=STREAM_STEPS,
            batch=TRAIN_BATCH, seq=TRAIN_SEQ, period=TRAIN_PERIOD,
            status_timeout=NODE_STATUS_TIMEOUT_S, sample_card=True))
        rep = shard_ft_report(run)
        problems = shard_ft_problems(run, rep, rounds=SHARD_FT_ROUNDS, layers=SHARD_S_LAYERS,
                                     device="cuda")
    finally:
        remove_later(root)
    timing = progress_timing(run)
    res = dict(
        model="llama2-7b", layers=SHARD_S_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
        rounds=SHARD_FT_ROUNDS, steps=STREAM_STEPS, options=SHARD_S_OPTIONS,
        chaos=SHARD_FT_CHAOS, deadline_s=SHARD_FT_DEADLINE_S, every=SHARD_FT_EVERY,
        ps_every=SHARD_FT_PS_EVERY,
        attempt=run["result"].attempt, membership=run["result"].ft, jobs=run["jobs"],
        step_ms=timing["step_ms"], progress_gap_max_s=timing["progress_gap_max_s"],
        disk_needed_gb=need / 1e9, card_peak_gib=(run["card_peak_mib"] or 0) / 1024,
        job_s=run["extra"].get("job_s"), seconds=time.perf_counter() - t0,
        **{k: v for k, v in rep.items() if k not in ("folds", "trainers")},
        trainers={peer: {k: t[k] for k in ("rejoin", "shard_catchups", "checkpoints",
                                           "launches", "peak_gib", "batches", "resends")}
                  for peer, t in rep["trainers"].items()},
        partial_folds=[f for f in rep["folds"] if f["prefold"]],
    )
    if problems:
        emit({"phase": "train_shard_ft", **res, "problems": problems,
              "logs": {k: v[-80:] for k, v in run["logs"].items()},
              "trainer_logs": {k: v[-40:] for k, v in trainer_logs(run).items()}})
        raise SystemExit("train_shard_ft phase failed: " + "; ".join(problems))
    return res


# ---------------------------------------------------------------------------
# train_het: WAN-adaptive rounds under the degrade chaos kinds
# ---------------------------------------------------------------------------

# A blocking int8 job of four trainers with straggler-adaptive inner steps
# and per-link codecs, under the reference hetbench's chaos kinds: w1's link
# capped, w2's batches slowed, w3's pushes jittered. One layer: each
# trainer's int8 wire is then 0.47 GB and its int4 wire 0.23 GB.
HET_LAYERS, HET_WORKERS = 1, 4
HET_MODEL = {**FT_MODEL, "config": {"num_layers": HET_LAYERS, "remat": True}}
# 3 rounds since train_lora and lora_7b joined the smoke (4 before, ~24 s
# a round): gate (c) reads round 2, the first after the warmup.
HET_ROUNDS, HET_STEPS = 3, 8
# The cap on w1's link (Mbit/s, both directions), and the codec ladder's
# thresholds: 1.6x the cap, and below the 2.2-5 Gbit/s the other links
# measured on the card (PERF.md §6), so w1 falls to int4 and every other
# link keeps int8 (hi == lo: no link is ever put on int8 from a faster base).
# A tighter cap lengthens w1's upload, and the controller's median (over
# all four peers) then sits too high for w2 to stand out of its deadband.
HET_RATE_MBPS = 1000.0
HET_HI_MBPS = HET_LO_MBPS = 1600.0
# The reference hetbench slows w2 4x. On one card w2's own steps run ~3x
# faster whenever the others wait (for w1's broadcast), and the healthy
# peers' arrival lags carry the server's sequential drains (~1 s each), so
# 4x (and 8x) read as a peer inside the controller's deadband from round 2
# on (PERF.md §6); 10x keeps its per-step cost over 1.5x the median's.
HET_SLOW = 10
HET_CHAOS = f"bw-cap:w1:{HET_RATE_MBPS:g},slow-worker:w2:{HET_SLOW},jitter:w3:0.2"
# The elastic deadline: past w1's int4 round and w2's slowed one (from the
# collect's start: the merge, the steps, the upload; ~6-8 s on the card);
# round 0 (every link unmeasured, the trainer processes starting) has the
# 6x first-round grace.
HET_DEADLINE_S = 14.0
# The throttle's chunk during the phase. The reference's 16 KiB sleeps once
# a chunk, and the event loop's timers resolve to about a millisecond, so it
# cannot pass more than ~16 MB/s; a 1 MiB chunk holds the cap at these rates.
HET_THROTTLE_CHUNK = 1 << 20
HET_STATUS_TIMEOUT_S = 240.0


def het_job(model: dict, *, rounds, steps, batch, lr, deadline_s, hi_mbps=HET_HI_MBPS,
            lo_mbps=HET_LO_MBPS):
    """``node_job`` for four workers with int8 deltas, ``adaptive_steps``
    and ``adaptive_codec`` at the given thresholds, and elastic rounds
    (quorum 0.5) with no spare to rejoin."""
    from hypha_tpu_torch.ft import FTConfig

    return node_job(model, rounds=rounds, steps=steps, batch=batch, lr=lr, workers=HET_WORKERS,
                    delta_codec="int8", adaptive_steps=True, adaptive_codec=True,
                    codec_bw_hi_mbps=hi_mbps, codec_bw_lo_mbps=lo_mbps,
                    ft=FTConfig(quorum_fraction=0.5, round_deadline_s=deadline_s,
                                rejoin_attempts=0))


@contextmanager
def het_probes(rec: dict, device):
    """The adaptive parts from inside: each round's frozen assignments
    (``StragglerController.start_round``), and each per-peer broadcast
    encode (``compress.write_delta`` called with a residual from the
    server's ``_broadcast_adaptive``): its peer (the wire's name carries a
    hash of it), codec, bytes and seconds, and the wire read back and held
    to ``update + residual_before - residual_after`` tensor by tensor on
    ``device`` (``rec["encodes_adaptive"]``, the largest error over the
    f32 rounding bound of the two operations), and whether its new
    residual shares a tensor or an ``ErrorFeedback`` with another peer's
    live one (``rec["residuals_shared"]``)."""
    from hypha_tpu_torch import compress
    from hypha_tpu_torch.compress import frame as frame_mod
    from hypha_tpu_torch.ft.adaptive import StragglerController

    rec.update(assignments=[], encodes_adaptive=[], residuals_shared=[], residual_tags=set())
    efs: dict = {}  # peer hash -> its ErrorFeedback, while the probe lasts
    start_round, write_delta = StragglerController.start_round, compress.write_delta

    def noted_start(self, round_num, peers=None):
        start_round(self, round_num, peers)
        rec["assignments"].append({"round": round_num, "steps": dict(self.assignments())})

    def checked_write(path, flat, codec, *a, ef=None, **kw):
        path = Path(path)
        if ef is None or len(path.name.split(".")) != 4:  # update-R.<peer hash>.wire.safetensors
            return write_delta(path, flat, codec, *a, ef=ef, **kw)
        before = dict(ef.state())
        _sync(device)
        t0 = time.perf_counter()
        sent = write_delta(path, flat, codec, *a, ef=ef, **kw)
        _sync(device)
        seconds = time.perf_counter() - t0
        del sent
        after = ef.state()
        # The wire decoded tensor by tensor (one at a time on the card).
        t1 = time.perf_counter()
        data = bytearray(path.read_bytes())
        header, payload = frame_mod._parse(data, path)
        worst = 0.0
        for entry in header["tensors"]:
            name = entry["name"]
            qoff, qlen, soff, slen = (int(entry[k]) for k in ("qoff", "qlen", "soff", "slen"))
            u = flat[name].to(torch.float32)
            q = torch.frombuffer(payload[qoff:qoff + qlen], dtype=torch.uint8).to(device)
            sc = torch.frombuffer(bytearray(payload[soff:soff + slen]), dtype=torch.float32)
            got = compress.dequantize(q, sc.to(device), u.numel(), header["codec"],
                                      header["chunk"]).reshape(-1)
            comp = (u + before[name] if name in before else u).reshape(-1)
            want = comp - after[name].reshape(-1)
            bound = 4 * torch.finfo(torch.float32).eps * float(comp.abs().max()) + 1e-30
            worst = max(worst, float((got - want).abs().max()) / bound)
            del q, got, comp, want
        del data, payload, before
        tag = path.name.split(".")[1]
        rec["encodes_adaptive"].append({
            "round": int(path.name.split("-")[1].split(".")[0]), "tag": tag, "codec": codec,
            "bytes": path.stat().st_size, "s": seconds, "err_over_bound": worst,
            "check_s": time.perf_counter() - t1})
        efs[tag] = ef
        rec["residual_tags"].add(tag)
        mine = {t.data_ptr() for t in after.values()}
        for other, oef in efs.items():
            if other != tag and (oef is ef or mine & {t.data_ptr() for t in oef.state().values()}):
                rec["residuals_shared"].append((tag, other))
        return None  # the server drops what write_delta returns here

    StragglerController.start_round = noted_start
    compress.write_delta = checked_write
    try:
        yield rec
    finally:
        StragglerController.start_round = start_round
        compress.write_delta = write_delta
        efs.clear()


async def run_het_job(root: Path, model: dict, *, device, rounds, steps, batch, seq, period,
                      lr=3e-4, deadline_s=HET_DEADLINE_S, chaos=HET_CHAOS, hi_mbps=HET_HI_MBPS,
                      lo_mbps=HET_LO_MBPS, throttle_chunk=HET_THROTTLE_CHUNK,
                      limit_s=CLI_LIMIT_S, train_runtime="process", auction_timeout=2.0,
                      status_timeout=None, sample_card=False, slo_rules=None,
                      metrics_interval_s=METRICS_INTERVAL_S) -> dict:
    """``het_job`` on the port's nodes at 127.0.0.1 (``run_ft_job``'s
    fabric): gateway, data node, train workers ``w0``-``w3``, ``psw``
    hosting the parameter server and the port's ``Orchestrator``, with a
    ``ChaosController`` on ``chaos`` attached before anything starts (the
    degrade kinds fire on attach): ``bw-cap`` throttles every push from
    and to ``w1``, ``slow-worker`` stretches ``w2``'s Status answers,
    ``jitter`` delays every push touching ``w3``.

    With ``slo_rules`` (a list, empty or not) the job runs the live
    metrics plane: every node reports each ``metrics_interval_s``, the
    scheduler's collector evaluates the rules and journals into the trace
    directory (the phase runs traced).

    Returns what ``node_probes``, ``ft_probes`` (each collect) and
    ``het_probes`` saw, the logs of the server, the adaptive tables and the
    scheduler, the job states, the files left over, (with ``sample_card``)
    the card's peak memory, and (with the plane) the collector's reports
    and SLO state."""
    import dataclasses
    import logging

    from hypha_tpu_torch.data_node import DataNode
    from hypha_tpu_torch.ft import ChaosController, chaos as chaos_mod, parse_chaos_specs
    from hypha_tpu_torch.gateway import Gateway
    from hypha_tpu_torch.network import Node, TcpTransport
    from hypha_tpu_torch.resources import Resources
    from hypha_tpu_torch.scheduler.orchestrator import Orchestrator
    from hypha_tpu_torch.worker.arbiter import OfferConfig
    from hypha_tpu_torch.worker.runtime import WorkerNode

    data_dir = root / "data"
    data_dir.mkdir(parents=True)
    write_slices(data_dir, n_slices=4, per_slice=rounds * steps * batch, seq=seq, period=period,
                 seed=9)
    job = het_job(model, rounds=rounds, steps=steps, batch=batch, lr=lr, deadline_s=deadline_s,
                  hi_mbps=hi_mbps, lo_mbps=lo_mbps)
    if slo_rules is not None:
        job = dataclasses.replace(job, metrics_plane=True, metrics_interval_s=metrics_interval_s,
                                  slo_rules=list(slo_rules))
    listen = ["127.0.0.1:0"]
    gw = Gateway(TcpTransport(), peer_id="gw")
    await gw.start(listen)
    boot = [gw.node.listen_addrs[0]]
    data = DataNode(TcpTransport(), {NODE_DATASET: data_dir}, peer_id="data", bootstrap=boot)
    workers = {f"w{i}": WorkerNode(
        TcpTransport(), resources=Resources(gpu=1, cpu=8, memory=65536), device=device,
        peer_id=f"w{i}", train_runtime=train_runtime, offer=OfferConfig(strategy="whole"),
        bootstrap=boot, work_root=root / f"w{i}") for i in range(HET_WORKERS)}
    psw = WorkerNode(TcpTransport(), resources=Resources(cpu=8, memory=65536), device=device,
                     peer_id="psw", bootstrap=boot, work_root=root / "ps")
    node = Node(TcpTransport(), peer_id="sched", bootstrap=boot)
    chunk = chaos_mod._THROTTLE_CHUNK
    chaos_mod._THROTTLE_CHUNK = throttle_chunk
    ctl = ChaosController(parse_chaos_specs(chaos, "w0"), {**workers, "psw": psw},
                          clock=time.perf_counter)
    logs: dict = {"ps": [], "sched": [], "link": []}

    class Lines(logging.Handler):
        def __init__(self, key):
            super().__init__()
            self.key = key

        def emit(self, record):
            logs[self.key].append(f"{time.perf_counter():.3f} {record.getMessage()}")

    handlers = [(logging.getLogger(n), Lines(k)) for n, k in (
        ("hypha.torch.worker.ps", "ps"), ("hypha.torch.ft.adaptive", "link"),
        ("hypha.torch.scheduler.orchestrator", "sched"))]
    levels = [lg.level for lg, _ in handlers]
    for lg, h in handlers:
        lg.addHandler(h)
        lg.setLevel(logging.INFO)
    started: list = []
    stop_errors: list = []
    stalls: list = []
    peak = [0.0]
    sampling = asyncio.Event()
    tasks = [asyncio.create_task(watch_loop(stalls))]
    if sample_card:
        tasks.append(asyncio.create_task(_device_mem_sampler(peak, sampling)))
    t_job = time.perf_counter()
    with node_probes(device) as rec, ft_probes(rec, None, lambda *a: None, lambda *a: None), \
            het_probes(rec, device):
        try:
            for part in (data, *workers.values(), psw, node):
                await part.start(listen)
                started.append(part)
            await node.wait_for_bootstrap()
            t_job = time.perf_counter()
            orch = Orchestrator(node)
            result = await orch.run(
                job, auction_timeout=auction_timeout, status_timeout=status_timeout)
            job_s = time.perf_counter() - t_job
            final = {"completed", "failed", "cancelled"}
            loop = asyncio.get_running_loop()
            deadline = loop.time() + limit_s
            while True:
                live = {d["job_id"] for d in rec["dispatch"]}
                ended = {s["job_id"] for s in rec["statuses"] if s["state"] in final}
                finished = live <= ended
                if finished or loop.time() > deadline:
                    break
                await asyncio.sleep(0.1)
        finally:
            chaos_mod._THROTTLE_CHUNK = chunk
            sampling.set()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            for part in reversed(started):
                try:
                    await part.stop()
                except Exception as e:  # noted; het_problems fails on it
                    stop_errors.append(f"{getattr(part, 'peer_id', part)}: {e!r}")
            await gw.stop()
            for (lg, h), level in zip(handlers, levels):
                lg.removeHandler(h)
                lg.setLevel(level)
    leftover: list = []
    for _ in range(300):
        leftover = sorted(str(p.relative_to(root)) for p in root.rglob("*")
                          if p.is_file() and not p.is_relative_to(data_dir))
        if not leftover:
            break
        await asyncio.sleep(0.1)
    jobs = {}
    for d in rec["dispatch"]:
        key = d["peer"] if d["kind"] == "train" else "aggregate"
        jobs[key] = [s["state"] for s in rec["statuses"] if s["job_id"] == d["job_id"]]
    plane = orch.metrics
    return dict(job=job, result=result, rec=rec, finished=finished, logs=logs, jobs=jobs,
                chaos=[(a.kind, a.target, a.fired_at) for a in ctl.fired], job_s=job_s,
                t_job=t_job, stop_errors=stop_errors, leftover=leftover, batch=batch,
                card_peak_mib=peak[0] if sample_card else None,
                loop_stall_max_s=max(stalls, default=0.0),
                workers=list(workers),
                plane=plane and {"reports": plane.reports, "slo": plane.watchdog.state(),
                                 "journal": str(plane.journal_path)})


_ARRIVALS = re.compile(r"round (\d+) UPDATED \(answered \w+\); arrival_s (\{.*\})")
_INNER = re.compile(r"inner steps (\{.*\}) \(epoch (\d+)\)")
_LINK = re.compile(r"link estimate: peer (\S+) (\d+) bytes in ([\d.]+) s, estimate ([\d.]+) bit/s")
_SWITCH = re.compile(r"per-link codec hint: switching upload codec (\S+) -> (\S+)")


def het_report(run: dict) -> dict:
    """What ``run_het_job`` measured, per round and per peer."""
    import ast

    rec, logs = run["rec"], trainer_logs(run)
    ps_log = "\n".join(run["logs"]["ps"])
    peers = run["workers"]
    tags = {hashlib.sha256(p.encode()).hexdigest()[:12]: p for p in peers}
    batches: dict = collections.Counter()
    for p in rec["progress"]:
        if p["kind"] == "status" and p["peer"] in peers:
            batches[(p["peer"], p["round"])] += 1
    updated_t = {p["round"]: p["t"] for p in rec["progress"] if p["kind"] == "updated"}
    arrivals = {int(r): ast.literal_eval(a) for r, a in _ARRIVALS.findall(ps_log)}
    link = [(float(line.split()[0]), m.groups()) for line in run["logs"]["link"]
            for m in [_LINK.search(line)] if m]
    rounds = sorted(updated_t)
    per_round = []
    for r in rounds:
        t_end, t_start = updated_t[r], updated_t.get(r - 1, run["t_job"])
        deltas = {d["from"]: d for d in rec["deltas"] if d["round"] == r}
        bcast = [b for b in rec["broadcast"] if b["round"] == r]
        assigned = next((a["steps"] for a in rec["assignments"] if a["round"] == r), None)
        per_round.append({
            "round": r,
            "wall_s": t_end - t_start,
            "assigned": assigned,
            "batches": {p: batches[(p, r)] for p in peers},
            "weighted_steps": {p: (d["header"].get("num_samples") or 0) / run["batch"]
                               for p, d in deltas.items()},
            "upload_codec": {p: (d["frame"] or {}).get("codec", "none") for p, d in deltas.items()},
            "upload_bytes": {p: d["bytes"] for p, d in deltas.items()},
            "upload_s": {p: d["s"] for p, d in deltas.items()},
            "arrival_s": arrivals.get(r),
            "bandwidth_bps": {p: float(est) for t, (p, n, s, est) in link if t <= t_end},
            "broadcast": sorted(((b["to"] or [None])[0], (b["header"] or {}).get("codec"),
                                 b["bytes"], round(b["s"], 3)) for b in bcast),
            "encodes": sorted((tags.get(e["tag"], e["tag"]), e["codec"], e["bytes"],
                               round(e["s"], 3), e["err_over_bound"])
                              for e in rec["encodes_adaptive"] if e["round"] == r),
        })
    per: dict = {}
    for peer, lines in logs.items():
        text = "\n".join(lines)
        found = re.search(r"attention launches: (\{.*\})", text)
        peak = re.search(r"peak device memory: ([\d.]+) GiB", text)
        per[peer] = {"launches": json.loads(found.group(1)) if found else None,
                     "peak_gib": float(peak.group(1)) if peak else None,
                     "batches": sum(n for (p, _), n in batches.items() if p == peer),
                     "switches": _SWITCH.findall(text)}
    shared = sorted({(tags.get(a, a), tags.get(b, b)) for a, b in rec["residuals_shared"]})
    return dict(
        per_round=per_round, trainers=per,
        updated=sorted(updated_t),
        published=[(int(e), ast.literal_eval(s)) for s, e in _INNER.findall(ps_log)],
        collects=[{"round": c["round"], "s": c["t1"] - c["t0"], "peers": c["peers"]}
                  for c in rec["collects"]],
        quorum_drops=re.findall(r"round (\d+) quorum drop: (.*)", ps_log),
        abandoned=re.findall(r"delta drain from (\S+) for round (\d+) abandoned", ps_log),
        residuals_shared=shared,
        residual_peers=sorted(tags.get(t, t) for t in rec["residual_tags"]),
    )


def het_problems(run: dict, rep: dict, *, rounds: int, steps: int, layers: int, device: str,
                 capped: str = "w1", slow: str = "w2") -> list:
    """The gates of ``train_het`` (a)-(g), on the CPU as on the card."""
    result, problems = run["result"], []
    peers = run["workers"]
    by_round = {r["round"]: r for r in rep["per_round"]}
    # (a) The capped peer's round-0 int8 delta lands (inside the grace);
    # no delta is dropped or abandoned in any round.
    r0 = by_round.get(0) or {}
    if (r0.get("upload_codec") or {}).get(capped) != "int8":
        problems.append(f"(a) {capped}'s round-0 delta: {r0.get('upload_codec')}, wanted int8")
    for c in rep["collects"]:
        if c["peers"] != sorted(peers):
            problems.append(f"(a) round {c['round']} collected {c['peers']}, wanted all of {peers}")
    if rep["quorum_drops"] or rep["abandoned"]:
        problems.append(f"(a) quorum drops {rep['quorum_drops']}, abandoned {rep['abandoned']}")
    # (b) From round 1 the capped link is int4 both ways; the others int8.
    for r in range(rounds):
        row = by_round.get(r) or {}
        bcodec = {to: codec for to, codec, _, _ in row.get("broadcast") or []}
        want_b = {p: ("int4" if p == capped else "int8") for p in peers}
        if bcodec != want_b:
            problems.append(f"(b) round {r} broadcast codecs {bcodec}, wanted {want_b}")
        if r >= 1:
            want_u = {p: ("int4" if p == capped else "int8") for p in peers}
            if row.get("upload_codec") != want_u:
                problems.append(f"(b) round {r} upload codecs {row.get('upload_codec')}, "
                                f"wanted {want_u}")
    for peer, t in rep["trainers"].items():
        want = [("int8", "int4")] if peer == capped else []
        if t["switches"] != want:
            problems.append(f"(b) {peer}'s codec switches {t['switches']}, wanted {want}")
    # (c) The slow peer runs fewer than the base steps after the warmup.
    for r in range(2, rounds):
        a = (by_round.get(r) or {}).get("assigned") or {}
        if not a.get(slow, steps) < steps:
            problems.append(f"(c) round {r}: {slow} assigned {a.get(slow)}, wanted < {steps}")
    # (d) Assignments = batches run = the weight the server folded.
    published = [s for _, s in rep["published"]]
    for r in range(rounds):
        row = by_round.get(r) or {}
        ran, weighted = row.get("batches") or {}, row.get("weighted_steps") or {}
        want = row.get("assigned") if r >= 1 else {p: steps for p in peers}
        if not want or ran != want or {p: round(v) for p, v in weighted.items()} != want \
                or any(v != round(v) for v in weighted.values()):
            problems.append(f"(d) round {r}: assigned {want}, batches {ran}, weighted {weighted}")
        if r >= 1 and want not in published:
            problems.append(f"(d) round {r}'s assignment {want} not among the server's "
                            f"membership updates {published}")
    # (e) Each per-peer wire decodes to update + residual_before - residual_after.
    for r in range(rounds):
        enc = (by_round.get(r) or {}).get("encodes") or []
        if sorted(p for p, *_ in enc) != sorted(peers) or any(e[4] > 1.0 for e in enc):
            problems.append(f"(e) round {r} encodes {enc}: wanted one per peer within the bound")
    if rep["residuals_shared"] or rep["residual_peers"] != sorted(peers):
        problems.append(f"(e) residuals of {rep['residual_peers']}, shared "
                        f"{rep['residuals_shared']}")
    # (f) Flash launches per trainer: exact.
    for peer in peers:
        t = rep["trainers"].get(peer, {})
        n = t.get("batches") or 0
        want = {"fwd": 2 * layers * n, "dq": layers * n, "dkv": layers * n, "flash_plain": 0,
                "dense": 0}
        if device != "cuda":
            want = {"fwd": 0, "dq": 0, "dkv": 0, "flash_plain": 0, "dense": layers * n}
        if not n or t.get("launches") != want:
            problems.append(f"(f) {peer}: attention launches {t.get('launches')}, wanted {want}")
    # (g) Every round closed, clean exits, no file left.
    if not run["finished"] or result.rounds != rounds or result.attempt != 0 \
            or rep["updated"] != list(range(rounds)):
        problems.append(f"(g) job: finished {run['finished']}, rounds {result.rounds}, attempt "
                        f"{result.attempt}, UPDATED {rep['updated']}")
    for key in (*peers, "aggregate"):
        states = run["jobs"].get(key) or []
        if not states or states[-1] != "completed":
            problems.append(f"(g) {key}: job states {states}, wanted completed last")
    if run["leftover"] or run["stop_errors"]:
        problems.append(f"(g) files left {run['leftover']}, stop errors {run['stop_errors']}")
    return problems


def train_het_phase() -> dict:
    """WAN-adaptive rounds on the card (``run_het_job``): a capped link on
    int4, a 4x slow worker on fewer steps, a jittered one, no drop; held
    to ``het_problems``; traced (``het_trace_problems``) and with the live
    metrics plane on (``het_metrics_problems``)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_reserved() / 2**30
    cost_us = span_cost_us()
    rules = het_slo_rules()
    root = Path(tempfile.mkdtemp(prefix="hhet"))
    tdir = None
    try:
        with traced_phase("train_het") as tdir:
            run = asyncio.run(run_het_job(
                root, HET_MODEL, device="cuda", rounds=HET_ROUNDS, steps=HET_STEPS,
                batch=TRAIN_BATCH, seq=TRAIN_SEQ, period=TRAIN_PERIOD,
                status_timeout=HET_STATUS_TIMEOUT_S, sample_card=True, slo_rules=rules))
        rep = het_report(run)
        problems = het_problems(run, rep, rounds=HET_ROUNDS, steps=HET_STEPS, layers=HET_LAYERS,
                                device="cuda")
        recs, journal_bytes = metrics_journal(tdir)
        problems += [f"metrics {x}" for x in het_metrics_problems(
            run, rep, recs, round_wall_s=HET_ROUND_WALL_S)]
        plane = {**plane_figures(recs, journal_bytes), "sample_us": sample_cost_us(),
                 "sample_cost_n": SAMPLE_COST_N, "interval_s": METRICS_INTERVAL_S,
                 "rules": rules, "collector": run["plane"]}
        print(f"[train_het metrics] {json.dumps(plane)}", flush=True)
        tproblems, tfig = het_trace_problems(tdir, run, rounds=HET_ROUNDS,
                                             rate_mbps=HET_RATE_MBPS)
        problems += [f"trace {x}" for x in tproblems]
        tsum = trace_summary(tdir, "train_het")
        # The cost of tracing a round: its spans at the measured cost of one,
        # against the median steady round's wall.
        walls = [row["wall_s"] for row in tfig["steady"]]
        round_wall = statistics.median(walls) if walls else None
        share = (cost_us * 1e-6 * tfig["spans_per_round"] / round_wall) if round_wall else None
        if share is None or share > SPAN_COST_BUDGET:
            problems.append(f"trace cost {share} of a round (budget {SPAN_COST_BUDGET})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if tdir is not None:
            shutil.rmtree(tdir, ignore_errors=True)
    timing = progress_timing(run)
    step_ms = {}
    for peer in run["workers"]:
        one = progress_timing({**run, "workers": [peer]})
        step_ms[peer] = one["step_ms"]
    res = dict(
        model="llama2-7b", layers=HET_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
        rounds=HET_ROUNDS, base_steps=HET_STEPS, chaos=HET_CHAOS, deadline_s=HET_DEADLINE_S,
        codec_bw_mbps=[HET_HI_MBPS, HET_LO_MBPS], throttle_chunk=HET_THROTTLE_CHUNK,
        attempt=run["result"].attempt, jobs=run["jobs"], step_ms=step_ms,
        progress_gap_max_s=timing["progress_gap_max_s"],
        card_peak_gib=(run["card_peak_mib"] or 0) / 1024, job_s=run["job_s"],
        server_process_gib={"reserved_at_start": held_gib,
                            "peak_allocated": torch.cuda.max_memory_allocated() / 2**30,
                            "peak_reserved": torch.cuda.max_memory_reserved() / 2**30},
        outer_step_s=run["rec"]["outer_step_s"], fold_s_max=max(run["rec"]["fold_s"], default=None),
        check_s=[e["check_s"] for e in run["rec"]["encodes_adaptive"]],
        loop_stall_max_s=run["loop_stall_max_s"], seconds=time.perf_counter() - t0,
        trace={**tfig, **{k: v for k, v in tsum.items() if k != "timeline"},
               "span_us": cost_us, "span_cost_n": SPAN_COST_N, "round_wall_s": round_wall,
               "share_of_round": share},
        metrics_plane=plane,
        **{k: v for k, v in rep.items() if k != "trainers"},
        trainers={peer: {k: t[k] for k in ("launches", "peak_gib", "batches", "switches")}
                  for peer, t in rep["trainers"].items()},
    )
    if problems:
        emit({"phase": "train_het", **res, "problems": problems,
              "logs": {k: v[-60:] for k, v in run["logs"].items()},
              "trainer_logs": {k: v[-40:] for k, v in trainer_logs(run).items()}})
        raise SystemExit("train_het phase failed: " + "; ".join(problems))
    return res


# ---------------------------------------------------------------------------
# train_swap: the broadcast tree and live weight swap
# ---------------------------------------------------------------------------

# A blocking int8 job of three trainers in one reduce group (w0 reduces and
# relays), the broadcast tree on, and a serving worker sv0 following every
# round. One layer: a whole-model update is then one 0.47 GB wire a round.
SWAP_LAYERS, SWAP_WORKERS = 1, 3
SWAP_MODEL = {**FT_MODEL, "config": {"num_layers": SWAP_LAYERS, "remat": True}}
# sv0 builds the same θ₀ (seed, widths) and serves it in bf16.
SWAP_SERVE_MODEL = {"family": "llama", "preset": "llama2-7b", "seed": 0,
                    "config": {"num_layers": SWAP_LAYERS}}
SWAP_ROUNDS, SWAP_STEPS = 3, 4  # 2 relayed rounds, then 1 direct (5 rounds, then 4, before)
SWAP_DEADLINE_S = 70.0  # FT_DEADLINE_S's reasoning: no round reaches it
# The watchdog: a healthy run's longest progress gap is a round boundary
# (seconds); a stalled one fails the phase in 4 minutes, not 10.
SWAP_STATUS_TIMEOUT_S = 240.0
SWAP_KILL_AFTER = 1  # w0 is killed once its relay handed round 1 on (2 until train_het)
SWAP_SERVE = "swap"
# sv0's pool: the serving phases' geometry, prefix cache on.
SWAP_POOL = dict(slots=8, max_len=1024, steps_per_call=8, block_size=16, ragged=True,
                 prefix_cache=True)
SWAP_NEW = 32  # new tokens of every request
SWAP_CLIENTS = (41, 43)  # each closed-loop client's prompt seed
SWAP_PROMPT_LENGTHS = (17, 60, 113, 150, 200)  # each client cycles over these
SWAP_PROBE = 64  # the probe prompt's length


def swap_job(model: dict, *, rounds, steps, batch, lr, deadline_s, workers=SWAP_WORKERS):
    """``node_job`` with int8 deltas, one reduce group of all the workers
    (its first peer id reduces and relays), the broadcast tree, ``sv0`` as
    a serving follower, and elastic rounds (quorum 0.5) with no spare to
    rejoin."""
    from hypha_tpu_torch.ft import FTConfig

    return node_job(model, rounds=rounds, steps=steps, batch=batch, lr=lr, workers=workers,
                    delta_codec="int8", reduce_group_size=workers, broadcast_tree=True,
                    serve_peers=["sv0"],
                    ft=FTConfig(quorum_fraction=0.5, round_deadline_s=deadline_s,
                                rejoin_attempts=0))


@contextmanager
def swap_probes(rec: dict, on_relayed):
    """The tree and the follower from inside: each relay (``rec["relays"]``)
    with ``on_relayed(peer, round)`` once a relay handed a wire on and
    injected its copy; each results-stream file any node saves, with its
    sender, header, sha-256 and bytes (``rec["saved"]``); each departure
    the scheduler makes; each weight subscriber started."""
    import hashlib

    from hypha_tpu_torch.network.node import PushStream
    from hypha_tpu_torch.scheduler.orchestrator import Orchestrator
    from hypha_tpu_torch.serving.weight_stream import WeightSubscriber
    from hypha_tpu_torch.stream.reduce import BroadcastRelay

    saved = (BroadcastRelay.start, BroadcastRelay._relay, PushStream.save_to,
             Orchestrator._depart, WeightSubscriber.start)
    start, relay, save_to, depart, sub_start = saved

    def noted_start(self):
        rec["relays"].append(self)
        return start(self)

    async def noted_relay(self, push):
        await relay(self, push)
        r = push.resource if isinstance(push.resource, dict) else {}
        on_relayed(self.node.peer_id, r.get("round"))

    async def hashed_save(self, path, chunk=1 << 22, hasher=None):
        r = self.resource if isinstance(self.resource, dict) else {}
        if not str(r.get("resource", "")).startswith("results"):
            return await save_to(self, path, chunk, hasher)
        h = hasher or hashlib.sha256()
        n = await save_to(self, path, chunk, h)
        rec["saved"].append({"path": str(path), "from": self.peer, "header": dict(r),
                             "sha256": h.hexdigest(), "bytes": n, "t": time.perf_counter()})
        return n

    async def noted_depart(self, ctx, peer, reason, add):
        if ctx.membership is not None and peer in ctx.membership.active:
            rec["departures"].append({"peer": peer, "t": time.perf_counter(), "reason": reason})
        return await depart(self, ctx, peer, reason, add)

    def noted_sub(self):
        rec["subscribers"].append(self)
        return sub_start(self)

    for key in ("relays", "saved", "departures", "subscribers"):
        rec.setdefault(key, [])
    BroadcastRelay.start, BroadcastRelay._relay = noted_start, noted_relay
    PushStream.save_to, Orchestrator._depart = hashed_save, noted_depart
    WeightSubscriber.start = noted_sub
    try:
        yield rec
    finally:
        (BroadcastRelay.start, BroadcastRelay._relay, PushStream.save_to, Orchestrator._depart,
         WeightSubscriber.start) = saved


def _noted_ps_push(node, rec: dict, wires: Path, hold=None) -> None:
    """Record each results push the parameter server makes (target, tag,
    round, outcome, seconds) and keep each round's wire (a hard link, its
    sha-256 beside it). With ``hold``, a round's pushes first await
    ``hold(round)``."""
    import hashlib

    push = node.push

    def sha(path) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            while chunk := f.read(1 << 22):
                h.update(chunk)
        return h.hexdigest()

    lock = asyncio.Lock()

    async def noted(peer_id, resource, source):
        r = resource if isinstance(resource, dict) else {}
        if not str(r.get("resource", "")).startswith("results"):
            return await push(peer_id, resource, source)
        rnd = r.get("round")
        if hold is not None:
            await hold(rnd)
        async with lock:  # a tree wave pushes one round to several peers at once
            if rnd not in rec["ps_wires"]:
                keep = wires / f"round-{rnd}"
                await asyncio.to_thread(os.link, source, keep)
                rec["ps_wires"][rnd] = {"path": str(keep),
                                        "sha256": await asyncio.to_thread(sha, keep),
                                        "header": dict(r), "bytes": keep.stat().st_size}
        entry = {"round": rnd, "to": peer_id, "tag": r.get("resource"), "t0": time.perf_counter(),
                 "ok": False}
        rec["ps_pushes"].append(entry)
        out = await push(peer_id, resource, source)
        entry.update(ok=True, s=time.perf_counter() - entry["t0"])
        return out

    node.push = noted


async def run_swap_job(root: Path, model: dict, serve_model: dict, *, device, rounds, steps,
                       batch, seq, period, lr=3e-4, deadline_s=SWAP_DEADLINE_S,
                       limit_s=CLI_LIMIT_S, train_runtime="process", new_tokens=SWAP_NEW,
                       prompt_lengths=SWAP_PROMPT_LENGTHS, probe_len=SWAP_PROBE,
                       pool=SWAP_POOL, vocab=32_000, status_timeout=None,
                       sample_card=False, progress_every=0.0) -> dict:
    """``swap_job`` on the port's nodes at 127.0.0.1: gateway, data node,
    trainers ``w0``-``w2`` (``w0`` reduces and relays), ``psw`` hosting the
    parameter server, ``sv0`` (a node whose infer executor serves
    ``serve_model`` and follows the job's broadcast from θ₀, started when
    the scheduler has planned the job's streams: ``follow_for`` over its
    results tag, shard and relay heads, ``keep_previous``), a ``client``
    node and the port's ``Orchestrator``. Two closed-loop clients ask sv0
    for ``new_tokens`` after prompts of ``prompt_lengths`` for the whole
    job; after each round sv0 applies, a probe prompt goes out, and the
    server's pushes of the next round wait for its answer (so no flip
    lands inside a probe; it changes no computation). ``w0`` is killed
    (``ChaosController``) once its relay handed round ``SWAP_KILL_AFTER``
    on, before the server's next broadcast.

    Returns what ``node_probes`` and ``swap_probes`` saw, the server's
    pushes and wires, the clients' and probes' responses (stamps, tokens,
    times), sv0's swap log, decode chunk times, prefix lookups, launch
    counts and subscriber stats, the logs, the chaos time and the peak. A
    failed job is returned with its error (``extra["error"]``); every
    ``progress_every`` seconds (0: never) a line on stderr says where the
    run is."""
    import logging

    from hypha_tpu_torch import aio
    from hypha_tpu_torch.data_node import DataNode
    from hypha_tpu_torch.ft import ChaosController, parse_chaos_specs
    from hypha_tpu_torch.gateway import Gateway
    from hypha_tpu_torch.messages import (
        PROTOCOL_GENERATE, Executor, GenerateRequest, InferExecutorConfig, JobSpec)
    from hypha_tpu_torch.network import Node, TcpTransport
    from hypha_tpu_torch.ops.paged_attention import paged_attention, ragged_paged_attention
    from hypha_tpu_torch.resources import Resources
    from hypha_tpu_torch.scheduler.orchestrator import Orchestrator
    from hypha_tpu_torch.serving import follow_for
    from hypha_tpu_torch.worker.arbiter import OfferConfig
    from hypha_tpu_torch.worker.infer_executor import InProcessInferExecutor
    from hypha_tpu_torch.worker.runtime import WorkerNode

    data_dir, wires = root / "data", root / "wires"
    data_dir.mkdir(parents=True)
    wires.mkdir()
    write_slices(data_dir, n_slices=4, per_slice=rounds * steps * batch, seq=seq, period=period,
                 seed=5)
    job = swap_job(model, rounds=rounds, steps=steps, batch=batch, lr=lr, deadline_s=deadline_s)
    listen = ["127.0.0.1:0"]
    gw = Gateway(TcpTransport(), peer_id="gw")
    await gw.start(listen)
    boot = [gw.node.listen_addrs[0]]
    data = DataNode(TcpTransport(), {NODE_DATASET: data_dir}, peer_id="data", bootstrap=boot)
    trainers = {f"w{i}": WorkerNode(
        TcpTransport(), resources=Resources(gpu=1, cpu=8, memory=65536), device=device,
        peer_id=f"w{i}", train_runtime=train_runtime, offer=OfferConfig(strategy="whole"),
        bootstrap=boot, work_root=root / f"w{i}") for i in range(SWAP_WORKERS)}
    psw = WorkerNode(TcpTransport(), resources=Resources(cpu=8, memory=65536), device=device,
                     peer_id="psw", bootstrap=boot, work_root=root / "psw")
    sv0 = Node(TcpTransport(), peer_id="sv0", bootstrap=boot)
    client = Node(TcpTransport(), peer_id="client", bootstrap=boot)
    node = Node(TcpTransport(), peer_id="sched", bootstrap=boot)
    actions = parse_chaos_specs(f"kill-worker:{SWAP_KILL_AFTER + 1}", "w0")
    chaos = ChaosController(actions, dict(trainers), clock=time.perf_counter)

    def on_relayed(peer: str, round_num) -> None:
        if peer == "w0" and round_num == SWAP_KILL_AFTER:
            chaos.on_round_metrics(SWAP_KILL_AFTER)

    logs: dict = {"ps": [], "sched": [], "relay": [], "sv0": []}

    class Lines(logging.Handler):
        def __init__(self, key):
            super().__init__()
            self.key = key

        def emit(self, record):
            logs[self.key].append(f"{time.perf_counter():.3f} {record.getMessage()}")

    handlers = [(logging.getLogger(n), Lines(k)) for n, k in (
        ("hypha.torch.worker.ps", "ps"), ("hypha.torch.scheduler.orchestrator", "sched"),
        ("hypha.torch.stream.reduce", "relay"), ("hypha.torch.executor.pool", "sv0"),
        ("hypha.torch.serving.weight_stream", "sv0"),
        ("hypha.torch.worker.infer_executor", "sv0"))]
    levels = [lg.level for lg, _ in handlers]
    for lg, h in handlers:
        lg.addHandler(h)
        lg.setLevel(logging.INFO)
    ex = InProcessInferExecutor(sv0, torch.device(device), root / "sv0")
    prompts = {seed: make_prompts(seed, list(prompt_lengths), vocab=vocab)
               for seed in SWAP_CLIENTS}
    probe = make_prompts(31, [probe_len], vocab=vocab)[0]
    out: dict = {"clients": {seed: [] for seed in SWAP_CLIENTS}, "probes": [], "chunks": [],
                 "lookups": [], "plan": None, "follow": None}
    ready, stop = asyncio.Event(), asyncio.Event()
    rec_ps: dict = {"ps_pushes": [], "ps_wires": {}}
    probed = collections.defaultdict(asyncio.Event)  # round -> its probe answered

    async def after_probe(round_num) -> None:
        """Round r leaves the server once round r - 1's probe is answered
        (at most a minute later), so no flip lands inside a probe. A hold
        like ``train_ft``'s: it changes no computation."""
        if isinstance(round_num, int) and round_num >= 1:
            try:
                await asyncio.wait_for(probed[round_num - 1].wait(), 60.0)
            except asyncio.TimeoutError:
                pass

    _noted_ps_push(psw.node, rec_ps, wires, hold=after_probe)

    async def ask(prompt: list) -> tuple:
        t0 = time.perf_counter()
        resp = await client.request("sv0", PROTOCOL_GENERATE, GenerateRequest(
            serve_name=SWAP_SERVE, prompts=[prompt], max_new_tokens=new_tokens),
            timeout=NODE_WAIT_S)
        return resp, t0, time.perf_counter()

    async def serve_follower():
        """sv0's job, dispatched once the scheduler planned the streams."""
        while out["plan"] is None:
            await asyncio.sleep(0.01)
        tag, shards, groups = out["plan"]
        out["follow"] = follow = follow_for(tag, shards, groups=groups, start_round=-1,
                                            keep_previous=True)
        spec = JobSpec(job_id="sv0-follow", executor=Executor(
            kind="infer", name="generate", infer=InferExecutorConfig(
                model=dict(serve_model), serve_name=SWAP_SERVE, max_batch=pool["slots"],
                max_new_tokens=new_tokens, pool_slots=pool["slots"],
                pool_max_len=pool["max_len"], pool_chunk=pool["steps_per_call"],
                pool_block_size=pool["block_size"], pool_ragged=pool["ragged"],
                pool_prefix_cache=pool["prefix_cache"], load_report_s=0.0,
                serve_follow_rounds=follow)))
        out["execution"] = await ex.execute("sv0-follow", spec, "sched")
        ended = asyncio.ensure_future(out["execution"].wait())
        while "sv0-follow" not in ex.batchers:
            if ended.done():
                raise SystemExit(f"sv0's job ended before serving: {ended.result()}")
            await asyncio.sleep(0.05)
        ended.cancel()
        dp = ex.batchers["sv0-follow"].pool
        out["pool"] = dp
        # Each decode chunk's start and end, and each prefix lookup's blocks
        # with the generation they were registered under.
        run_chunk, lookup = dp._run_decode_chunk, dp._alloc.lookup

        def timed_chunk(dec):
            t0 = time.perf_counter()
            run_chunk(dec)
            out["chunks"].append((t0, time.perf_counter(), dp.weight_round))

        def checked_lookup(hashes):
            ids = lookup(hashes)
            out["lookups"].append((dp._alloc.generation,
                                   [dp._alloc._gen_of.get(b) for b in ids]))
            return ids

        dp._run_decode_chunk, dp._alloc.lookup = timed_chunk, checked_lookup
        ragged_paged_attention.launches = paged_attention.plain_calls = 0
        for name in ROUTES:
            setattr(ragged_paged_attention, f"{name}_launches", 0)
        out["chunks0"], out["prefill0"] = dp.chunks, dp.prefill_chunks
        ready.set()

    async def traffic(seed: int):
        await ready.wait()
        i = 0
        while not stop.is_set():
            p = prompts[seed][i % len(prompts[seed])]
            resp, t0, t1 = await ask(p)
            out["clients"][seed].append({"t0": t0, "t1": t1, "ok": resp.ok, "len": len(p),
                                         "tokens": len(resp.tokens[0]) if resp.tokens else 0,
                                         "stamp": (resp.weight_round, resp.weight_generation)})
            i += 1

    async def prober():
        await ready.wait()
        dp, seen = out["pool"], None
        while True:
            state = dp.weight_state()
            if state[0] is not None and state != seen:
                resp, t0, t1 = await ask(probe)
                stamp = (resp.weight_round, resp.weight_generation)
                out["probes"].append({"state": state, "stamp": stamp, "tokens": resp.tokens[0],
                                      "clean": stamp == state == dp.weight_state(), "t0": t0,
                                      "t1": t1})
                probed[state[0]].set()
                seen = state
            if stop.is_set() and seen == dp.weight_state():
                return
            await asyncio.sleep(0.02)

    def status() -> dict:
        """Where the run is, for the lines a long phase prints as it goes."""
        dp = out.get("pool")
        prog = collections.Counter(f"{p['peer']}:{p['kind']}" for p in rec["progress"])
        return {"t": round(time.perf_counter() - t_start, 1), "progress": dict(prog),
                "statuses": [(s["job_id"][-3:], s["state"]) for s in rec["statuses"]],
                "ps_pushes": [(p["round"], p["to"], p["ok"]) for p in rec_ps["ps_pushes"]],
                "relayed": [len(r.hops) for r in rec["relays"]],
                "swaps": dp and dp.weight_state(), "requests": {
                    seed: len(cl) for seed, cl in out["clients"].items()},
                "stall_max_s": round(max(stalls, default=0.0), 3),
                "departures": [d["peer"] for d in rec["departures"]],
                "logs": {k: v[-3:] for k, v in logs.items()},
                "trainers": {k: v[-3:] for k, v in trainer_logs({"rec": rec}).items()}}

    async def progress_lines(every: float):
        while True:
            await asyncio.sleep(every)
            print(json.dumps({"train_swap_progress": status()}, default=str), file=sys.stderr,
                  flush=True)

    real_plan = Orchestrator._plan_streams

    def noted_plan(self, ctx, *a, **kw):
        real_plan(self, ctx, *a, **kw)
        out["plan"] = (ctx.results_tag, list(ctx.shard_map.shards),
                       [list(g) for g in ctx.shard_map.groups])

    started: list = []
    tasks: list = []
    stalls: list = []
    peak, sampling = [0.0], asyncio.Event()
    extra: dict = {}
    Orchestrator._plan_streams = noted_plan
    t_start = time.perf_counter()
    with node_probes(device) as rec, swap_probes(rec, on_relayed):
        try:
            for part in (data, *trainers.values(), psw, sv0, client, node):
                await part.start(listen)
                started.append(part)
            await node.wait_for_bootstrap()
            await client.wait_for_bootstrap()
            tasks = [asyncio.create_task(watch_loop(stalls)),
                     asyncio.create_task(serve_follower()),
                     *(asyncio.create_task(traffic(s)) for s in SWAP_CLIENTS),
                     asyncio.create_task(prober())]
            if sample_card:
                tasks.append(asyncio.create_task(_device_mem_sampler(peak, sampling)))
            if progress_every:
                tasks.append(asyncio.create_task(progress_lines(progress_every)))
            t_job = time.perf_counter()
            try:
                result = await Orchestrator(node).run(job, auction_timeout=2.0,
                                                      status_timeout=status_timeout)
            except Exception as e:  # reported by swap_problems with the logs
                result, extra["error"] = None, repr(e)
            extra["job_s"] = time.perf_counter() - t_job
            final = {"completed", "failed", "cancelled"}
            loop = asyncio.get_running_loop()
            deadline = loop.time() + (limit_s if result is not None else 30.0)
            while True:
                live = {d["job_id"] for d in rec["dispatch"] if d["peer"] != "w0"}
                ended = {s["job_id"] for s in rec["statuses"] if s["state"] in final}
                finished = live <= ended
                if finished or loop.time() > deadline:
                    break
                await asyncio.sleep(0.1)
            # The last round's flip, then its probe.
            dp = out.get("pool")
            while (result is not None and dp is not None and dp.weight_round != rounds - 1
                   and loop.time() < deadline):
                await asyncio.sleep(0.05)
            stop.set()
            await asyncio.wait_for(asyncio.gather(*tasks[2:5]), NODE_WAIT_S)
            if dp is not None:
                out["launches"] = {"decode": ragged_paged_attention.decode_launches,
                                   "mma": ragged_paged_attention.mma_launches,
                                   "simt": ragged_paged_attention.simt_launches,
                                   "plain": paged_attention.plain_calls,
                                   "decode_chunks": dp.chunks - out["chunks0"],
                                   "prefill_chunks": dp.prefill_chunks - out["prefill0"]}
                out["swap_log"] = list(dp.swap_log)
                out["alloc"] = {"generation": dp._alloc.generation,
                                "stale_drops": dp._alloc.stale_drops, "hit_blocks": dp.hit_blocks,
                                "swaps": (dp.swaps_applied, dp.swaps_deferred,
                                          dp.swaps_rolled_back)}
                out["served_peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                                          if device == "cuda" else None)
            out["subscriber"] = rec["subscribers"][0].stats() if rec["subscribers"] else None
        finally:
            Orchestrator._plan_streams = real_plan
            stop.set()
            sampling.set()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            if out.get("execution") is not None:
                await out["execution"].cancel()
            for part in reversed(started):
                await part.stop()
            await gw.stop()
            for (lg, h), level in zip(handlers, levels):
                lg.removeHandler(h)
                lg.setLevel(level)
    leftover: list = []
    for _ in range(300):
        leftover = sorted(str(p.relative_to(root)) for p in root.rglob("*")
                          if p.is_file() and not p.is_relative_to(data_dir)
                          and not p.is_relative_to(wires))
        if not leftover:
            break
        await asyncio.sleep(0.1)
    jobs = {}
    for d in rec["dispatch"]:
        jobs[d["peer"] if d["kind"] == "train" else "aggregate"] = [
            s["state"] for s in rec["statuses"] if s["job_id"] == d["job_id"]]
    return dict(job=job, result=result, rec=rec, finished=finished, logs=logs, jobs=jobs,
                chaos={a.kind: a.fired_at for a in chaos.fired}, extra=extra,
                ps=rec_ps, serve=out, probe=probe, root=root, leftover=leftover,
                card_peak_mib=peak[0] if sample_card else None, status=status(),
                loop_stall_max_s=max(stalls, default=0.0))


def swap_check(run: dict, serve_model: dict, device: str, pool=SWAP_POOL) -> dict:
    """Gates 4 and 5 from the host's side: θ₀ built as sv0 built it, each
    flip of sv0's swap log replayed on ``device`` from the server's kept
    wires (the rounds a flip covers summed in f32 first, as the pool folds
    them; each leaf then ``(leaf.float() + u.float()).to(leaf.dtype)``),
    its digest against the one sv0 logged, and the probe of that round
    through a fresh pool of sv0's geometry on the folded weights (the same
    kernels) against the probe sv0 answered."""
    from hypha_tpu_torch.compress import read_delta
    from hypha_tpu_torch.executor.pool import DecodePool
    from hypha_tpu_torch.executor.training import theta_checksum
    from hypha_tpu_torch.models.convert import flat_names
    from hypha_tpu_torch.worker.infer_executor import load_model

    wires = run["ps"]["ps_wires"]
    model = load_model(dict(serve_model), device=device)
    names = flat_names(model)
    params = dict(model.named_parameters())
    probes = {p["state"][0]: p for p in run["serve"]["probes"] if p["clean"]}
    checks, applied = [], -1
    for entry in run["serve"].get("swap_log", []):
        if entry["what"] != "applied":
            checks.append({"round": entry["round"], "what": entry["what"], "ok": False})
            continue
        pend: dict = {}
        for r in range(applied + 1, entry["round"] + 1):
            u = read_delta(wires[r]["path"], device=device)
            for k, v in u.items():
                k = k.removeprefix("params/")
                pend[k] = pend[k] + v.float() if k in pend else v.float()
        with torch.no_grad():
            for k, u in pend.items():
                pname, transposed = names[k]
                leaf = params[pname]
                u = u.T if transposed else u
                leaf.data = (leaf.float() + u.float()).to(leaf.dtype).contiguous()
        del pend
        first, applied = applied + 1, entry["round"]
        digest = theta_checksum({n: params[p] for n, (p, _) in names.items()})
        got = probes.get(applied)
        want = None
        if got is not None:
            ref = DecodePool(model, **pool)
            try:
                want = ref.submit([run["probe"]], len(got["tokens"])).result(timeout=NODE_WAIT_S)[0]
            finally:
                ref.close()
        checks.append({"round": applied, "rounds_folded": applied + 1 - first, "digest": digest,
            "logged": entry["digest"], "digest_equal": digest == entry["digest"],
            "probe": got is not None, "tokens_equal": got is not None and got["tokens"] == want,
            "tokens": got["tokens"] if got else None})
    del model
    return {"checks": checks}


def swap_report(run: dict) -> dict:
    """What ``run_swap_job`` measured: per round, the server's pushes
    (target, tag, outcome) and how its tree broadcast went (top targets or
    expansion, from its log); every results file each node saved against
    the server's wire of that round (sha-256, header); the trainers'
    launches and batches; sv0's swaps, launches, decode-chunk gaps around
    each flip, tokens/s before and after the first swap, the clients'
    stamps; the relay hops; kill to departure."""
    rec, serve, ps = run["rec"], run["serve"], run["ps"]
    root = str(run["root"])
    rounds = sorted(ps["ps_wires"])

    def who(path: str) -> str:
        rel = Path(path).relative_to(root).parts[0] if path.startswith(root) else "?"
        return rel

    received = []
    for s in rec["saved"]:
        r = s["header"].get("round")
        want = ps["ps_wires"].get(r)
        hdr = {k: v for k, v in s["header"].items() if k != "resource"}
        want_hdr = want and {k: v for k, v in want["header"].items() if k != "resource"}
        received.append({"at": who(s["path"]), "from": s["from"], "round": r,
                         "tag": s["header"].get("resource"), "bytes": s["bytes"],
                         "sha_equal": bool(want) and s["sha256"] == want["sha256"],
                         "header_equal": hdr == want_hdr})
    pushes = {r: [(p["to"], p["tag"], p["ok"]) for p in ps["ps_pushes"] if p["round"] == r]
              for r in rounds}
    ps_log = "\n".join(run["logs"]["ps"])
    modes = {}
    for r in rounds:
        m = re.search(rf"tree broadcast round {r} to (\[.*?\]) of", ps_log)
        modes[r] = {"targets": m and m.group(1)}
    expansions = re.findall(r"relay (\S+) unreachable; expanding to \d+ children (\[.*?\])",
                            ps_log)
    trainers: dict = {}
    for peer, lines in trainer_logs(run).items():
        t = trainer_log("\n".join(lines))
        trainers[peer] = {"launches": t["launches"], "peak_gib": t["peak_gib"],
                          "batches": sum(p["kind"] == "status" and p["peer"] == peer
                                         for p in rec["progress"])}
    swaps = serve.get("swap_log", [])
    flips = [s["t"] for s in swaps]
    chunks = serve["chunks"]
    gaps = [b[1] - a[1] for a, b in zip(chunks, chunks[1:])]
    around = []
    for t in flips:
        near = [b[1] - a[1] for a, b in zip(chunks, chunks[1:]) if a[1] <= t <= b[1] + 1e-3]
        around.append(max(near) if near else None)
    first = flips[0] if flips else None
    done = [c for cl in serve["clients"].values() for c in cl if c["ok"]]

    def rate(lo, hi):
        got = [c for c in done if lo <= c["t1"] < hi]
        return (sum(c["tokens"] for c in got) / (hi - lo)) if got and hi > lo else None

    t_lo = min((c["t0"] for c in done), default=None)
    t_hi = max((c["t1"] for c in done), default=None)
    relays = [{"peer": r.node.peer_id, "children": r.children,
               "hops": [{"round": h["header"].get("round"), "bytes": h["bytes"],
                         "save_s": h["save_s"], "push_s": h["push_s"],
                         "delivered": h["delivered"], "lost": h["lost"]}
                        for h in r.hops]} for r in rec["relays"]]
    deps = {d["peer"]: d["t"] for d in rec["departures"]}
    fired = run["chaos"].get("kill")
    return dict(
        rounds=rounds, pushes=pushes, broadcast=modes, expansions=expansions,
        received=received, trainers=trainers, relays=relays,
        updated=sorted(p["round"] for p in rec["progress"] if p["kind"] == "updated"),
        deltas=[(d["round"], d["from"], bool(d["header"].get("prefold")),
                 d["header"].get("covers")) for d in rec["deltas"]],
        departures=[(d["peer"], d["reason"]) for d in rec["departures"]],
        kill_to_departure_s=(deps["w0"] - fired) if "w0" in deps and fired else None,
        swaps=[{k: s[k] for k in ("what", "round", "generation", "staged_to_flip_ms", "flip_ms",
                                  "alloc_generation", "live_rows")} for s in swaps],
        decode_gap_median_s=statistics.median(gaps) if gaps else None,
        decode_gap_at_flip_s=around,
        tokens_per_s_before_first_swap=rate(t_lo, first) if first and t_lo else None,
        tokens_per_s_after_first_swap=rate(first, t_hi) if first and t_hi else None,
        requests=len(done), launches=serve.get("launches"), alloc=serve.get("alloc"),
        subscriber=serve.get("subscriber"),
        stamps={seed: [c["stamp"] for c in cl] for seed, cl in serve["clients"].items()},
        probes=[{"round": p["state"][0], "clean": p["clean"], "latency_s": p["t1"] - p["t0"]}
                for p in serve["probes"]],
    )


def swap_problems(run: dict, rep: dict, check: dict, *, rounds: int, layers: int,
                  device: str) -> list:
    """The seven gates of ``train_swap``."""
    problems = []
    if run["extra"].get("error") or run["result"] is None:
        return [f"the job failed: {run['extra'].get('error')}; at {run['status']}"]
    kill = SWAP_KILL_AFTER + 1
    # 1. Every wire a leaf got through the relay is the server's, byte for
    # byte, with its header.
    relayed = [x for x in rep["received"] if x["from"] == "w0" and x["at"] in ("w1", "w2", "sv0")]
    if not relayed or any(not (x["sha_equal"] and x["header_equal"]) for x in rep["received"]):
        problems.append(f"gate 1: relayed or received wires differ from the server's: "
                        f"{[x for x in rep['received'] if not (x['sha_equal'] and x['header_equal'])]}")
    if {(x["at"], x["round"]) for x in relayed} != {
            (p, r) for p in ("w1", "w2", "sv0") for r in range(kill)}:
        problems.append(f"gate 1: relayed receipts {sorted((x['at'], x['round']) for x in relayed)}")
    # 2. One push a round to the relay while it lives; then the leaves
    # directly, by expansion or top_targets.
    for r in range(rounds):
        ok = sorted((to, tag) for to, tag, good in rep["pushes"].get(r, []) if good)
        if r < kill:
            want = [("w0", f"{run['serve']['follow'].results.ref.resource}.relay")]
        else:
            tag = run["serve"]["follow"].results.ref.resource
            want = sorted((p, tag) for p in ("sv0", "w1", "w2"))
        if ok != want:
            problems.append(f"gate 2: round {r} pushes {rep['pushes'].get(r)}, wanted {want}")
    # 3. The job survives: every round UPDATED once, the survivors' deltas
    # straight to the shard after the kill, every live leaf every round.
    if rep["updated"] != list(range(rounds)):
        problems.append(f"gate 3: UPDATED rounds {rep['updated']}")
    late = sorted((r, frm) for r, frm, prefold, _ in rep["deltas"] if r >= kill)
    if late != sorted((r, p) for r in range(kill, rounds) for p in ("w1", "w2")):
        problems.append(f"gate 3: deltas after the kill {late}")
    got = {(x["at"], x["round"]) for x in rep["received"]
           if x["tag"] == run["serve"]["follow"].results.ref.resource}
    want = {(p, r) for p in ("w1", "w2", "sv0") for r in range(rounds)}
    if not want <= got:
        problems.append(f"gate 3: leaves missed rounds {sorted(want - got)}")
    sub = rep["subscriber"] or {}
    if sub.get("held_rounds") != [] or sub.get("applied_round") != rounds - 1:
        problems.append(f"gate 3: the follower's stats {sub}")
    if [d for d in rep["departures"] if d[0] != "w0"] or "w0" not in [d[0] for d in
                                                                       rep["departures"]]:
        problems.append(f"gate 3: departures {rep['departures']}")
    jobs = run["jobs"]
    if any(jobs.get(p, [None])[-1] != "completed" for p in ("w1", "w2", "aggregate")):
        problems.append(f"gate 3: jobs {jobs}")
    # 4. and 5. Each flip bit-equal to the host's fold; each probe's tokens
    # the fresh pool's on it.
    checks = check["checks"]
    if [c["round"] for c in checks] != list(range(rounds)):
        problems.append(f"gate 4: flips {[(c['round'], c.get('what')) for c in checks]}")
    for c in checks:
        if not c.get("digest_equal"):
            problems.append(f"gate 4: round {c['round']} served digest {c.get('logged')} != host "
                            f"fold {c.get('digest')}")
        if not c.get("probe") or not c.get("tokens_equal"):
            problems.append(f"gate 5: round {c['round']} probe {c.get('probe')}, tokens equal "
                            f"{c.get('tokens_equal')}")
    # 6. Traffic unhurt: every answer whole, stamps among the applied rounds
    # and never falling per client, no pre-swap chain mapped after a swap,
    # the allocator's generation one a swap.
    applied = {(s["round"], s["generation"]) for s in rep["swaps"]}
    for seed, cl in run["serve"]["clients"].items():
        bad = [c for c in cl if not c["ok"] or c["tokens"] != SWAP_NEW]
        if bad or not cl:
            problems.append(f"gate 6: client {seed}: {len(bad)} of {len(cl)} requests failed or "
                            "came back short")
        stamps = [c["stamp"] for c in cl]
        keys = [-1 if s[0] is None else s[0] for s in stamps]
        if keys != sorted(keys) or any(s[0] is not None and s not in applied for s in stamps):
            problems.append(f"gate 6: client {seed} stamps {stamps}")
    stale = [lk for lk in run["serve"]["lookups"] if any(g != lk[0] for g in lk[1])]
    if stale:
        problems.append(f"gate 6: {len(stale)} admissions mapped a chain of an older generation")
    alloc = rep["alloc"] or {}
    if alloc.get("generation") != len(rep["swaps"]) or alloc.get("swaps") != (rounds, 0, 0):
        problems.append(f"gate 6: allocator {alloc}, swaps {len(rep['swaps'])}")
    # 7. Launch counts exact: every trainer batch through the flash kernels,
    # every sv0 forward through the ragged kernel.
    if device == "cuda":
        for peer, t in rep["trainers"].items():
            n = t["batches"]
            want = {"fwd": 2 * layers * n, "dq": layers * n, "dkv": layers * n,
                    "flash_plain": 0, "dense": 0}
            if peer != "w0" and (not n or t["launches"] != want):
                problems.append(f"gate 7: {peer} launches {t['launches']}, wanted {want}")
        lc = rep["launches"] or {}
        want = {"decode": lc.get("decode_chunks", -1) * SWAP_POOL["steps_per_call"] * layers,
                "mma": lc.get("prefill_chunks", -1) * layers, "simt": 0, "plain": 0}
        if {k: lc.get(k) for k in want} != want or not want["decode"] or not want["mma"]:
            problems.append(f"gate 7: sv0 launches {lc}, wanted {want}")
    if run["leftover"]:
        problems.append(f"left in the work root: {run['leftover']}")
    return problems


def swap_summary(run: dict, rep: dict, check: dict) -> dict:
    """The phase's line: ``swap_report`` with the checks, the wires' bytes,
    whether the probe's tokens moved between rounds, the peaks."""
    tokens = [c.get("tokens") for c in check["checks"]]
    return dict(
        attempt=getattr(run["result"], "attempt", None), jobs=run["jobs"],
        job_s=run["extra"].get("job_s"),
        wire_bytes={r: w["bytes"] for r, w in run["ps"]["ps_wires"].items()},
        probe_tokens_differ_between_rounds=len({tuple(t or ()) for t in tokens}) > 1,
        card_peak_gib=(run["card_peak_mib"] or 0) / 1024,
        sv0_peak_gib=run["serve"].get("served_peak_gib"),
        loop_stall_max_s=run["loop_stall_max_s"],
        checks=[{k: c.get(k) for k in ("round", "rounds_folded", "digest", "digest_equal",
                                       "tokens_equal")} for c in check["checks"]],
        **{k: v for k, v in rep.items() if k not in ("received", "stamps")},
        received=dict(collections.Counter(f"{x['at']}<-{x['from']}" for x in rep["received"])),
    )


def train_swap_phase() -> dict:
    """The broadcast tree and live weight swap on the card
    (``run_swap_job``): a 7B-width blocking job relayed through ``w0``,
    ``sv0`` following it round by round under traffic, ``w0`` killed after
    relaying round ``SWAP_KILL_AFTER``; held to ``swap_problems``."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    root = Path(tempfile.mkdtemp(prefix="hsw"))
    try:
        run = asyncio.run(run_swap_job(
            root, SWAP_MODEL, SWAP_SERVE_MODEL, device="cuda", rounds=SWAP_ROUNDS,
            steps=SWAP_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, period=TRAIN_PERIOD,
            status_timeout=SWAP_STATUS_TIMEOUT_S, sample_card=True, progress_every=30.0))
        t_check = time.perf_counter()
        rep = swap_report(run)
        check = (swap_check(run, SWAP_SERVE_MODEL, "cuda") if run["result"] is not None
                 else {"checks": []})
        check_s = time.perf_counter() - t_check
        problems = swap_problems(run, rep, check, rounds=SWAP_ROUNDS, layers=SWAP_LAYERS,
                                 device="cuda")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res = dict(model="llama2-7b", layers=SWAP_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
               steps=SWAP_STEPS, workers=SWAP_WORKERS, kill_after=SWAP_KILL_AFTER,
               check_s=check_s, **swap_summary(run, rep, check),
               seconds=time.perf_counter() - t0)
    if problems:
        emit({"phase": "train_swap", **res, "problems": problems, "status": run["status"],
              "logs": {k: v[-60:] for k, v in run["logs"].items()},
              "trainer_logs": {k: v[-40:] for k, v in trainer_logs(run).items()}})
        raise SystemExit("train_swap phase failed: " + "; ".join(problems))
    return res


# ---------------------------------------------------------- train_lora phase

# LoRA DiLoCo from an HF-format checkpoint: 7B widths at LORA_LAYERS, every
# supported target at rank 16, two trainers.
# 2 layers since train_data joined the smoke (4 before).
LORA_LAYERS, LORA_ROUNDS, LORA_STEPS, LORA_WORKERS = 2, 3, 4, 2
LORA = {"rank": 16, "alpha": 32.0, "targets": ["q_proj", "k_proj", "v_proj", "o_proj"]}
LORA_MODEL = {**TRAIN_MODEL, "config": {**TRAIN_MODEL["config"], "num_layers": LORA_LAYERS}}
LORA_PROBE = (2, 256)  # gate (f)'s fixed probe
LORA_PROMPTS, LORA_NEW = [17, 130], [8, 8]  # greedy tokens through the pool
# lora_7b: the whole Llama-2-7B shape, one round of LORA_7B_STEPS.
LORA_7B_STEPS = 6
LORA_7B_MODEL = {**TRAIN_MODEL, "config": {"remat": True}}


def lora_wire_spec(model: dict, lora: dict) -> dict:
    """``{flat name: ("F32", shape)}`` of a LoRA job's Δθ: the adapters of
    ``model`` with ``lora``'s (the trainer's injection into its config)."""
    from hypha_tpu_torch.executor.lora import split_lora
    from hypha_tpu_torch.models.convert import state_to_flat
    from hypha_tpu_torch.models.registry import build_model

    config = {**(model.get("config") or {}), "lora_rank": int(lora["rank"]),
              "lora_alpha": float(lora["alpha"]), "lora_targets": tuple(lora["targets"])}
    built, _ = build_model({**model, "config": config}, device="meta")
    adapters = split_lora(built.state_dict())[0]
    return {k: ("F32", tuple(v.shape)) for k, v in state_to_flat(built, adapters).items()}


def write_hf_checkpoint(path: Path, state: dict) -> dict:
    """``state`` (a model's ``state_dict``) in HF names and bf16, one
    SafeTensors file by the port's writer; its seconds and bytes."""
    from hypha_tpu_torch.executor.serialization import save_file
    from hypha_tpu_torch.models.convert import hf_state_dict

    t0 = time.perf_counter()
    save_file({k: v.to(torch.bfloat16) for k, v in hf_state_dict(state).items()}, path)
    return {"s": time.perf_counter() - t0, "bytes": path.stat().st_size}


def seeded_hf_source(path: Path, model: dict, device) -> dict:
    """The base of ``model``'s seeded init, drawn on ``device`` as a trainer
    draws it, written by ``write_hf_checkpoint``."""
    from hypha_tpu_torch.models.registry import build_model

    built, _ = build_model(model, device=device)
    built.init_weights(int(model.get("seed", 0)))
    out = write_hf_checkpoint(path, built.state_dict())
    del built
    return out


@contextmanager
def lora_probes(root: Path):
    """Inside each in-process trainer, known by its work dir under ``root``
    (``w0``, ``w1``): its model; its attention calls (each layer's
    ``attn_impl`` counted per trainer, the flash wrapper's counts staying
    the process's); the lines it logs; the names in each SafeTensors file
    a port connector pushes; and every merge: when the broadcast
    update is read, the names it carries and a copy of the tensors it
    updates (θ_t), and right after the merge (at the anchor checksum) each
    one must equal θ_t + u bit for bit."""
    import logging

    import hypha_tpu_torch.executor.training as training
    from hypha_tpu_torch.ops.flash_attention import flash_attention

    from hypha_tpu_torch.executor.serialization import read_header
    from hypha_tpu_torch.worker.connectors import Connector

    rec = {"models": {}, "attn_calls": collections.Counter(), "merges": [], "log": [],
           "pushed": []}
    local = threading.local()
    init, read, checksum = training._init_model, training._read_update, training.theta_checksum
    send = Connector.send

    async def noted_send(self, send_, path, resource, meta=None):
        if str(path).endswith(".safetensors"):
            rec["pushed"].append({"from": getattr(self.node, "peer_id", None),
                                  "names": sorted(read_header(path)[0])})
        return await send(self, send_, path, resource, meta)

    def peer_of(path) -> str:
        return Path(path).resolve().relative_to(root.resolve()).parts[0]

    def init_model(cfg, session, work_dir, device):
        model = init(cfg, session, work_dir, device)
        peer = peer_of(work_dir)
        rec["models"][peer] = model
        if device.type == "cuda":
            def counted(q, k, v, **kw):
                rec["attn_calls"][peer] += 1
                return flash_attention(q, k, v, **kw)

            for layer in model.layers:
                layer.self_attn.attn_impl = counted
        return model

    def read_update(path, device):
        update = read(path, device)
        peer = peer_of(path)
        state = rec["models"][peer].state_dict()
        local.pending = (peer, {n: state[n].clone() for n in update if n in state},
                         {n: u.clone() for n, u in update.items()})
        return update

    def merged_checksum(params):
        pending, local.pending = getattr(local, "pending", None), None
        if pending is not None:
            peer, before, update = pending
            state = rec["models"][peer].state_dict()
            bad = [n for n in before if not torch.equal(
                state[n], before[n] + update[n].to(state[n].device, state[n].dtype))]
            rec["merges"].append({"peer": peer, "names": sorted(update), "bad": bad})
        return checksum(params)

    class Lines(logging.Handler):
        def emit(self, record):
            rec["log"].append(record.getMessage())

    logger = logging.getLogger("hypha.torch.executor.training")
    handler, level = Lines(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    training._init_model, training._read_update = init_model, read_update
    training.theta_checksum, Connector.send = merged_checksum, noted_send
    try:
        yield rec
    finally:
        training._init_model, training._read_update, training.theta_checksum = init, read, checksum
        Connector.send = send
        logger.removeHandler(handler)
        logger.setLevel(level)


async def run_lora_job(root: Path, model: dict, source: Path, *, device, rounds, steps, batch,
                       seq, period, lr=3e-4, workers=LORA_WORKERS, lora=None,
                       status_timeout=None, sample_card=False, job_options=None) -> dict:
    """``run_node_job`` with a LoRA job (``lora``; ``job_options`` are
    further ``DiLoCoJob`` fields) whose ``source`` is the HF-format file
    ``source``, the trainers in process under ``lora_probes``. Returns
    ``run_node_job``'s result with the probes' record under ``lora``."""
    from hypha_tpu_torch.messages import Fetch, Reference, to_json_dict

    spec = {**model, "source": to_json_dict(Fetch(Reference.from_uri(source.as_uri())))}
    with lora_probes(root) as lrec:
        run = await run_node_job(root, spec, device=device, rounds=rounds, steps=steps,
                                 batch=batch, seq=seq, period=period, lr=lr, workers=workers,
                                 train_runtime="in-process", status_timeout=status_timeout,
                                 job_options={"lora": lora or LORA, **(job_options or {})},
                                 sample_card=sample_card)
    return {**run, "lora": lrec}


def base_matches_checkpoint(models: dict, source: Path, family: str = "llama") -> list:
    """The peers whose base is not the checkpoint's tensors after
    conversion (f32), bit for bit: ``convert_checkpoint`` streams the
    file, each tensor held against every trainer's."""
    from hypha_tpu_torch.models.convert import convert_checkpoint

    template = next(iter(models.values()))
    states = {peer: m.state_dict() for peer, m in models.items()}
    bad: set = set()

    def compare(name, t):
        for peer, state in states.items():
            if not torch.equal(state[name], t.to(state[name].device)):
                bad.add(f"{peer}:{name}")
        return t

    convert_checkpoint(family, source, template, dtype=torch.float32, put=compare)
    return sorted(bad)


def lora_problems(run: dict, *, rounds: int, steps: int, layers: int, lora: dict,
                  expect: dict, device: str) -> list:
    """Gates (a)-(e) of ``train_lora`` (``lora_phase`` adds (b) and (f)):
    ``node_problems`` on the job (its Δθ held to ``expect``, the adapters'
    wire spec); (a) every Δθ the server received and every update a
    trainer read exactly the adapters, ``expect``'s bytes (f32) plus a
    header; (c) every merge ``θ_t + u`` bit for bit, ``rounds`` a
    trainer; (d) the attention calls of every batch and every trainer's
    parameters on ``device``; (e) finite round losses."""
    rec, lrec = run["rec"], run["lora"]
    problems = node_problems(run, rounds=rounds, expect=expect)
    problems = [p for p in problems if "last not below" not in p]  # (e) gates no fall
    adapters = {_torch_name(n) for n in expect}
    payload = sum(4 * math.prod(shape) for _, shape in expect.values())
    for d in rec["deltas"]:
        if d["tensors"] != expect or not payload < d["bytes"] < payload + 65536:
            problems.append(f"(a) Δθ from {d['from']} round {d['round']}: {d['bytes']} bytes, "
                            f"{len(d['tensors'] or {})} tensors, wanted the {len(expect)} "
                            f"adapters in {payload} bytes plus a header")
    for b in rec["broadcast"]:
        if not payload < b["bytes"] < payload + 65536:
            problems.append(f"(a) broadcast round {b['round']}: {b['bytes']} bytes")
    merges = lrec["merges"]
    for peer in run["workers"]:
        mine = [m for m in merges if m["peer"] == peer]
        if len(mine) != rounds:
            problems.append(f"(c) {peer} merged {len(mine)} updates, wanted {rounds}")
        for m in mine:
            if set(m["names"]) != adapters:
                problems.append(f"(a) {peer} read an update of {len(m['names'])} tensors, "
                                f"wanted the {len(adapters)} adapters")
            if m["bad"]:
                problems.append(f"(c) {peer}: {len(m['bad'])} adapters not θ_t + u after the "
                                f"merge, e.g. {m['bad'][:3]}")
        model = lrec["models"].get(peer)
        if model is None or any(p.device.type != torch.device(device).type
                                for p in model.parameters()):
            problems.append(f"(d) {peer}'s parameters are not on {device}")
        batches = sum(p["kind"] == "status" and p["peer"] == peer for p in rec["progress"])
        if device != "cpu" and lrec["attn_calls"][peer] != 2 * layers * batches:
            problems.append(f"(d) {peer}: {lrec['attn_calls'][peer]} attention calls, wanted "
                            f"2 x {layers} x {batches} batches")
    for peer, r, m in run["result"].metrics:
        if not math.isfinite(m.get("loss", math.nan)):
            problems.append(f"(e) {peer} round {r}: loss {m.get('loss')}")
    return problems


def _torch_name(flat: str) -> str:
    from hypha_tpu_torch.models.convert import _torch_name as name

    return name(flat)[0]


def lora_fold_check(model, model_spec: dict, work: Path, device) -> dict:
    """Gate (f): ``fold_lora`` of ``model``'s adapters written as an HF
    checkpoint directory, loaded by ``load_model`` into a ``lora_rank=0``
    model in bf16 (streamed by ``convert_checkpoint``); its logits on a
    fixed probe against the adapters' (max |Δ| over max |logits|), then a
    few greedy tokens of two prompts through the paged, ragged pool."""
    from hypha_tpu_torch.executor.lora import fold_lora
    from hypha_tpu_torch.worker.infer_executor import load_model

    cfg = model.config
    folded_dir = work / "folded"
    folded_dir.mkdir()
    with torch.no_grad():
        folded = fold_lora(model.state_dict(), cfg.lora_alpha, cfg.lora_rank)
        wrote = write_hf_checkpoint(folded_dir / "model.safetensors", folded)
        del folded
    spec = {**{k: v for k, v in model_spec.items() if k != "source"},
            "weights": str(folded_dir)}
    t0 = time.perf_counter()
    served = load_model(spec, device=device)
    load_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(21)
    probe = (LORA_PROBE[0], min(LORA_PROBE[1], cfg.max_seq_len))
    ids = torch.randint(0, cfg.vocab_size, probe, generator=g).to(device)
    with torch.no_grad():
        want = model(ids).float()
        got = served(ids).float()
    gap = float((got - want).abs().max() / want.abs().max())
    pool = _pool_run(served, make_prompts(23, LORA_PROMPTS, cfg.vocab_size), LORA_NEW)
    del served
    return {"fold_gap": gap, "tol": LORA_FOLD_TOL, "write_s": wrote["s"], "bytes": wrote["bytes"],
            "load_s": load_s, "tokens": pool["answers"], "launches_by_route": pool["launches_by_route"],
            "plain_attention_calls": pool["plain_attention_calls"]}


def train_lora_phase() -> dict:
    """LoRA DiLoCo on the port's nodes from an HF-format bf16 checkpoint
    (``run_lora_job``): 7B widths at ``LORA_LAYERS``, ``LORA`` on every
    supported target, two in-process trainers, ``LORA_ROUNDS`` of
    ``LORA_STEPS``; gates (a)-(f) (``lora_problems``,
    ``base_matches_checkpoint``, ``lora_fold_check``)."""
    from hypha_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="hlo"))
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-lora-"))
    try:
        source = work / "model.safetensors"
        wrote = seeded_hf_source(source, LORA_MODEL, "cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.fwd_launches = flash_attention.dq_launches = 0
        flash_attention.dkv_launches = flash_attention.plain_calls = 0
        run = asyncio.run(run_lora_job(root, LORA_MODEL, source, device="cuda",
                                       rounds=LORA_ROUNDS, steps=LORA_STEPS, batch=TRAIN_BATCH,
                                       seq=TRAIN_SEQ, period=TRAIN_PERIOD,
                                       status_timeout=NODE_STATUS_TIMEOUT_S, sample_card=True))
        launches = {"fwd": flash_attention.fwd_launches, "dq": flash_attention.dq_launches,
                    "dkv": flash_attention.dkv_launches, "flash_plain": flash_attention.plain_calls}
        peak = torch.cuda.max_memory_allocated() / 2**30
        lrec = run["lora"]
        attn_calls = dict(lrec["attn_calls"])  # before the fold check's probe adds its own
        problems = lora_problems(run, rounds=LORA_ROUNDS, steps=LORA_STEPS, layers=LORA_LAYERS,
                                 lora=LORA, expect=lora_wire_spec(LORA_MODEL, LORA),
                                 device="cuda")
        batches = sum(p["kind"] == "status" for p in run["rec"]["progress"])
        want = {"fwd": 2 * LORA_LAYERS * batches, "dq": LORA_LAYERS * batches,
                "dkv": LORA_LAYERS * batches, "flash_plain": 0}
        if launches != want:
            problems.append(f"(d) flash launches {launches}, wanted {want}")
        t_check = time.perf_counter()
        bad_base = base_matches_checkpoint(lrec["models"], source) if lrec["models"] else ["-"]
        if bad_base:
            problems.append(f"(b) base tensors differ from the checkpoint's: {bad_base[:4]}")
        base_check_s = time.perf_counter() - t_check
        fold = lora_fold_check(lrec["models"]["w0"], LORA_MODEL, work, "cuda") \
            if "w0" in lrec["models"] else {"fold_gap": math.inf}
        if not fold["fold_gap"] <= LORA_FOLD_TOL:
            problems.append(f"(f) folded logits {fold['fold_gap']} of max |logits| from the "
                            f"adapters', over {LORA_FOLD_TOL}")
        if fold.get("plain_attention_calls") or not (fold.get("launches_by_route") or {}).get(
                "decode"):
            problems.append(f"(f) the folded model's serving launches {fold.get('launches_by_route')}")
        lrec["models"].clear()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    rec, result = run["rec"], run["result"]
    log = "\n".join(lrec["log"])
    loaded = [tuple(map(float, m)) for m in
              re.findall(r"fetched in ([\d.]+) s, loaded in ([\d.]+) s", log)]
    prog = rec["progress"]
    step_ms = {}
    for peer in run["workers"]:
        beats = [p for p in prog if p["kind"] == "status" and p["peer"] == peer]
        step_ms[peer] = statistics.median(
            [(b["t"] - a["t"]) * 1e3 for a, b in zip(beats, beats[1:]) if a["round"] == b["round"]]
            or [math.nan])
    rounds = {}
    for r in range(LORA_ROUNDS):
        rounds[r] = dict(
            push_bytes=[p["bytes"] for p in rec["push"] if p["round"] == r],
            push_s=[p["s"] for p in rec["push"] if p["round"] == r],
            broadcast_bytes=[b["bytes"] for b in rec["broadcast"] if b["round"] == r],
            broadcast_s=[b["s"] for b in rec["broadcast"] if b["round"] == r],
            loss_mean={w: m.get("loss") for w, rr, m in result.metrics if rr == r})
    timing = progress_timing(run)
    res = dict(
        model="llama2-7b", layers=LORA_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH, lora=LORA,
        rounds=LORA_ROUNDS, steps=LORA_STEPS, workers=run["workers"], jobs=run["jobs"],
        source={"write_s": wrote["s"], "bytes": wrote["bytes"],
                "fetch_s_load_s": loaded},
        per_round=rounds, fold_s=rec["fold_s"], outer_step_s=rec["outer_step_s"],
        round_boundary_s=timing["round_boundary_s"], step_ms=step_ms,
        tokens_per_s={p: TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3) for p, ms in step_ms.items()},
        launches=launches, attn_calls=attn_calls, merges=len(lrec["merges"]),
        base_check_s=base_check_s, fold=fold,
        peak_gib_process=peak, card_peak_mib=run["card_peak_mib"],
        seconds=time.perf_counter() - t0)
    if problems:
        emit({"phase": "train_lora", **res, "problems": problems, "log_tail": lrec["log"][-40:]})
        raise SystemExit("train_lora phase failed: " + "; ".join(problems))
    return res


# ------------------------------------------------------------ lora_7b phase

class LoraSession(TrainSession):
    """``TrainSession`` without the profiled step."""

    def on_status(self, now):
        pass


def chunked_ce_probe(hidden: torch.Tensor, head: torch.Tensor, labels: torch.Tensor) -> dict:
    """``chunked_causal_ce`` against ``compute_loss`` CE on the same hidden
    states: value and hidden gradient (relative to the loss and to the
    largest gradient; ``CHUNKED_CE_TOL``), and each one's peak memory
    above its inputs."""
    from hypha_tpu_torch.executor.train import chunked_causal_ce, compute_loss
    from hypha_tpu_torch.messages import Loss

    out = {}
    for name in ("full", "chunked"):
        h = hidden.detach().float().requires_grad_(True)  # f32 gradients: no bf16 rounding
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if name == "full":
            logits = torch.einsum("bse,ve->bsv", h.float(), head.float())
            loss = compute_loss(Loss.CROSS_ENTROPY, logits, labels)
            del logits
        else:
            loss = chunked_causal_ce(h, head, labels)
        (grad,) = torch.autograd.grad(loss, [h])
        torch.cuda.synchronize()
        out[name] = {"loss": float(loss.detach()), "grad": grad, "ms": (time.perf_counter() - t0) * 1e3,
                     "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
    ref, got = out["full"], out["chunked"]
    return {"loss": ref["loss"], "loss_rel_err": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_rel_err": float((got["grad"] - ref["grad"]).abs().max()
                                  / ref["grad"].abs().max()),
            "tol": CHUNKED_CE_TOL,
            **{f"{k}_{f}": out[k][f] for k in out for f in ("ms", "peak_gib")}}


def mu_dtype_probe(adapters: list, steps: int = 4) -> dict:
    """Four AdamW steps on copies of the adapters with the same seeded
    gradients, ``mu`` bf16 against f32: the moments' bytes and the largest
    parameter gap (over lr)."""
    from hypha_tpu_torch.executor.train import build_optimizer
    from hypha_tpu_torch.messages import Adam

    lr = 3e-4
    runs = {}
    for name, mu_dtype in (("f32", None), ("bf16", torch.bfloat16)):
        params = [p.detach().clone() for p in adapters]
        opt = build_optimizer(params, Adam(lr=lr, weight_decay=0.01), mu_dtype=mu_dtype)
        g = torch.Generator(device=params[0].device).manual_seed(31)
        for _ in range(steps):
            opt.step([torch.randn(p.shape, generator=g, device=p.device) * 1e-3 for p in params])
        runs[name] = (params, sum(m.numel() * m.element_size() for m in opt.mu),
                      sum(v.numel() * v.element_size() for v in opt.nu))
    gap = max(float((a - b).abs().max()) for a, b in zip(runs["f32"][0], runs["bf16"][0]))
    return {"steps": steps, "mu_bytes": {k: runs[k][1] for k in runs},
            "nu_bytes": {k: runs[k][2] for k in runs}, "param_gap_over_lr": gap / lr}


SEED_SOURCE = "hypha_tpu_torch/ops/csrc/seed_init.cu"
SEED_REPLACES = "hypha_tpu/executor/training.py:672"  # model.init's XLA draws: no Pallas kernel
SEED_CHECK = 65_536  # elements at each end of a leaf the CPU recomputes
SEED_SHAPE = (4096, 4096)  # the timed leaf: a q_proj kernel at 7B widths
# Operations of one drawn element: threefry's 20 rounds (add, two shifts,
# or, xor) and 5 key injections (~117 integer ops), the uniform (5), XLA's
# log (~35) and erf_inv's polynomial (9 fused multiply-adds, 18), the
# scale and clip (~5): counted at the CUDA cores' f32 rate.
SEED_OPS_PER_ELEMENT = 180


def generator_init(model, seed: int) -> None:
    """The port's seeded init before draws matched JAX's: a ``torch.Generator``
    on the card, normal(0.02) for embeddings, head and LoRA ``A``, lecun's
    truncated normal for projections (kept here to time it beside the
    JAX-equal init)."""
    g = torch.Generator(device=model.device).manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in ("embed_tokens", "lm_head") or name.endswith("_lora_a"):
                p.normal_(0.0, 0.02, generator=g)
            elif name.endswith("proj.weight"):
                std = (1.0 / p.shape[1]) ** 0.5 / 0.8796256610342398
                torch.nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=g)


def seed_check(model, seed: int) -> dict:
    """The card's seeded θ₀ against the CPU's draws of the same elements:
    the first and last ``SEED_CHECK`` flat elements (in the JAX layout) of
    one leaf of each distinct (shape, draw), and the first 1024 of every
    drawn leaf. Bit-equal, or the problem names the leaf."""
    from hypha_tpu_torch.models import seed_init

    params = dict(model.named_parameters())
    seen, checked, elements, bad = set(), [], 0, []
    for name, d, transposed in model.init_plan(seed):
        if d is None:
            continue
        k, kind, mul = d
        leaf = params[name].detach()
        flat = (leaf.t() if transposed else leaf).reshape(-1)
        n = flat.numel()
        span = [(0, min(n, 1024))]
        if (tuple(leaf.shape), kind) not in seen:
            seen.add((tuple(leaf.shape), kind))
            span = [(0, min(n, SEED_CHECK)), (max(n - SEED_CHECK, 0), n)]
            checked.append({"name": name, "shape": list(leaf.shape), "kind": kind})
        for a, b in span:
            want = seed_init.draw_plain(k, kind, a, b, mul=mul)
            got = flat[a:b].float().cpu()
            elements += b - a
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                bad.append({"name": name, "range": [a, b],
                            "max_abs_err": float((got - want).abs().max())})
    return {"leaves": checked, "elements": elements, "mismatches": bad}


def seed_kernel_timing(seed: int = 0) -> dict:
    """The draw kernel against its plain version (the same torch ops the CPU
    runs, here on the card) on a ``SEED_SHAPE`` lecun leaf: bit equality,
    times and the bound."""
    from hypha_tpu_torch.models import seed_init

    k = seed_init.param_key(seed_init.key(seed), ("layers_0", "self_attn", "q_proj"), 1)
    mul = seed_init.lecun_scale(SEED_SHAPE[0])
    n = SEED_SHAPE[0] * SEED_SHAPE[1]
    out = torch.empty(SEED_SHAPE, device="cuda")
    before = seed_init.seed_launches["draw"]
    ms = time_ms(lambda: seed_init.draw(k, "truncated_normal", out, mul=mul))
    seed_init.seed_launches["draw"] = before  # timing launches are not the path's
    with torch.inference_mode():
        plain = seed_init.draw_plain(k, "truncated_normal", 0, n, mul=mul, device="cuda")
        plain_ms = time_ms(lambda: seed_init.draw_plain(k, "truncated_normal", 0, n, mul=mul,
                                                         device="cuda"),
                           reps=3, iters=2, warmup=1)
    seed_init.draw(k, "truncated_normal", out, mul=mul)
    seed_init.seed_launches["draw"] = before
    torch.cuda.synchronize()
    err = float((out.reshape(-1) - plain).abs().max())
    equal = torch.equal(out.reshape(-1).view(torch.int32), plain.view(torch.int32))
    bytes_ms = n * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = n * SEED_OPS_PER_ELEMENT / PEAK_OPS[torch.float32] * 1e3
    return dict(shape=list(SEED_SHAPE), ms=ms, plain_ms=plain_ms, max_abs_err=err,
                bit_equal=equal, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def lora_7b_phase() -> dict:
    """The whole Llama-2-7B (32 layers, f32 base) trained with LoRA through
    ``run_training`` behind ``LoraSession``: one round of ``LORA_7B_STEPS``;
    gates: base unchanged (its checksum), adapters changed, finite losses,
    the flash launches of every step, peak under the card; then the
    chunked-CE and bf16-moment probes on the 7B head and adapters."""
    import hypha_tpu_torch.executor.training as training
    from hypha_tpu_torch.executor.lora import split_lora
    from hypha_tpu_torch.messages import Nesterov
    from hypha_tpu_torch.models import seed_init
    from hypha_tpu_torch.models.convert import state_to_flat
    from hypha_tpu_torch.models.llama import Llama
    from hypha_tpu_torch.ops.attention import dot_product_attention
    from hypha_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    work_dir = Path(tempfile.mkdtemp(prefix="chip-smoke-lora7b-"))
    sums: dict = {}
    init = training._init_model
    init_weights = Llama.init_weights

    def timed_init(self, seed=0):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = init_weights(self, seed)
        torch.cuda.synchronize()
        sums["init_s"], sums["seed"] = time.perf_counter() - t, int(seed)
        return out

    def init_model(cfg, session_, work_dir_, device):
        model = init(cfg, session_, work_dir_, device)
        session.model = model
        # θ₀ on the card against the CPU's draws, before training moves it.
        t_check = time.perf_counter()
        sums["seed_check"] = {**seed_check(model, sums["seed"]),
                              "seconds": time.perf_counter() - t_check}
        adapters, base = split_lora(model.state_dict())
        sums["base0"] = training.theta_checksum(state_to_flat(model, base))
        sums["adapters0"] = {k: v.clone() for k, v in adapters.items()}
        return model

    try:
        slices = write_slices(work_dir, n_slices=2, per_slice=LORA_7B_STEPS * TRAIN_BATCH // 2,
                              seq=TRAIN_SEQ, period=TRAIN_PERIOD, seed=6)
        session = LoraSession(work_dir, slices, rounds=1, steps=LORA_7B_STEPS, outer=Nesterov())
        spec = train_spec("chip-smoke-lora7b", LORA_7B_MODEL, batch=TRAIN_BATCH, lr=3e-4,
                          lora=dict(LORA))
        torch.cuda.reset_peak_memory_stats()
        flash_attention.fwd_launches = flash_attention.dq_launches = 0
        flash_attention.dkv_launches = flash_attention.plain_calls = 0
        dot_product_attention.calls = 0
        seed_init.seed_launches["draw"] = 0
        training._init_model = init_model
        Llama.init_weights = timed_init
        t_run = time.perf_counter()
        try:
            result = training.run_training(session, work_dir, spec)
        finally:
            training._init_model = init
            Llama.init_weights = init_weights
        seed_launches = seed_init.seed_launches["draw"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = {"fwd": flash_attention.fwd_launches, "dq": flash_attention.dq_launches,
                    "dkv": flash_attention.dkv_launches, "flash_plain": flash_attention.plain_calls,
                    "dense": dot_product_attention.calls}
        peak = torch.cuda.max_memory_allocated() / 2**30
        model = session.model
        cfg = model.config
        adapters, base = split_lora(model.state_dict())
        base_same = training.theta_checksum(state_to_flat(model, base)) == sums["base0"]
        changed = sum(not torch.equal(v, sums["adapters0"][k]) for k, v in adapters.items())
        n_params = sum(p.numel() for p in model.parameters())
        n_adapters = sum(p.numel() for p in adapters.values())
        # The probes: the 7B head on [2, 2048] final hidden states of this
        # model, and the adapters.
        g = torch.Generator().manual_seed(41)
        ids = torch.randint(0, TRAIN_PERIOD, (TRAIN_BATCH, TRAIN_SEQ), generator=g).cuda()
        with torch.no_grad():
            hidden = model(ids, with_head=False)
        ce = chunked_ce_probe(hidden[:, :-1], model.lm_head, ids[:, 1:])
        del hidden
        mu = mu_dtype_probe([p for n, p in model.named_parameters() if "_lora_" in n])
        # The torch.Generator init this port drew before, timed on the same
        # model (its weights are not needed any more).
        torch.cuda.synchronize()
        t_gen = time.perf_counter()
        generator_init(model, sums["seed"])
        torch.cuda.synchronize()
        seeded = {"seconds": sums["init_s"], "generator_seconds": time.perf_counter() - t_gen,
                  "launches": seed_launches, "check": sums["seed_check"],
                  "kernel": seed_kernel_timing(sums["seed"])}
        session.model = model = None
        sums.clear()
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    steps = session.step_ms()
    step_ms = statistics.median(steps) if steps else math.nan
    card = torch.cuda.get_device_properties(0).total_memory / 2**30
    res = dict(
        model="llama2-7b", layers=cfg.num_layers, params=n_params, adapter_params=n_adapters,
        lora=LORA, seq=TRAIN_SEQ, batch=TRAIN_BATCH, steps=result.batches, losses=result.losses,
        step_ms=step_ms, step_ms_all=steps, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
        peak_gib=peak, card_gib=card, wall_s=wall, update_phase_s=session.update_s,
        server_s=session.times, launches=launches, base_unchanged=base_same,
        adapters_changed=changed, adapters=len(adapters), chunked_ce=ce, mu_dtype=mu,
        init=seeded, seconds=time.perf_counter() - t0)
    want = {"fwd": 2 * cfg.num_layers * LORA_7B_STEPS, "dq": cfg.num_layers * LORA_7B_STEPS,
            "dkv": cfg.num_layers * LORA_7B_STEPS, "flash_plain": 0, "dense": 0}
    problems = []
    if result.batches != LORA_7B_STEPS or result.rounds != 1 \
            or not all(math.isfinite(x) for x in result.losses):
        problems.append(f"{result.rounds} rounds of {result.batches} steps, losses {result.losses}")
    if not base_same:
        problems.append("the frozen base changed")
    if changed != len(adapters):
        problems.append(f"{changed} of {len(adapters)} adapters changed")
    if launches != want:
        problems.append(f"launches {launches}, wanted {want}")
    if not peak < card:
        problems.append(f"peak {peak} GiB of the card's {card}")
    if not (ce["loss_rel_err"] <= CHUNKED_CE_TOL and ce["grad_rel_err"] <= CHUNKED_CE_TOL):
        problems.append(f"chunked CE against compute_loss: {ce}")
    drawn = sum(d is not None for _, d, _ in Llama(cfg, device="meta").init_plan(0))
    if seeded["check"]["mismatches"] or not seeded["check"]["leaves"]:
        problems.append(f"seeded init on the card differs from the CPU: {seeded['check']}")
    if seeded["launches"] != drawn:
        problems.append(f"{seeded['launches']} draw kernel launches, wanted one per drawn leaf "
                        f"({drawn})")
    if not seeded["kernel"]["bit_equal"]:
        problems.append(f"the draw kernel differs from its plain version: {seeded['kernel']}")
    if problems:
        emit({"phase": "lora_7b", **res, "problems": problems})
        raise SystemExit("lora_7b phase failed: " + "; ".join(problems))
    return res


class _PlainFlash(torch.autograd.Function):
    """The plain flash versions under autograd: the kernels' reference."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        from hypha_tpu_torch.ops.flash_attention import flash_forward_reference

        o, lse = flash_forward_reference(q, k, v, causal, None, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, None, window)
        return o

    @staticmethod
    def backward(ctx, do):
        from hypha_tpu_torch.ops.flash_attention import flash_backward_reference

        grads = flash_backward_reference(*ctx.saved_tensors, do.contiguous(), *ctx.args)
        return (*grads, None, None)


def plain_flash(q, k, v, *, causal=True, window=None):
    return _PlainFlash.apply(q, k, v, causal, window)


def train_reference_phase() -> dict:
    """A tiny Llama (hidden 256, 4 heads of 64, 2 kv heads), and the same
    with a sliding window of 48 below its sequence of 128 (Mistral's local
    attention), each trained 4 steps through the kernels and through the
    plain flash version, from the same weights and batches."""
    from hypha_tpu_torch.executor.train import build_optimizer, make_train_step
    from hypha_tpu_torch.messages import Adam
    from hypha_tpu_torch.models.registry import build_model
    from hypha_tpu_torch.ops.attention import dot_product_attention
    from hypha_tpu_torch.ops.flash_attention import flash_attention

    g = torch.Generator().manual_seed(9)
    batches = []
    for _ in range(4):
        start = torch.randint(0, 256, (4, 1), generator=g)
        batches.append({"input_ids": ((start + torch.arange(128)) % 256).cuda()})
    res = {}
    for variant, extra in (("full", {}), ("window48", {"sliding_window": 48})):
        losses = {}
        fwd, dense = flash_attention.fwd_launches, dot_product_attention.calls
        for label, impl in (("kernels", flash_attention), ("plain", plain_flash)):
            model, _ = build_model({"family": "llama", "preset": "tiny",
                                    "config": {"hidden_size": 256, **extra}},
                                   device="cuda", attn_impl=impl)
            model.init_weights(11)
            step = make_train_step(model, build_optimizer(list(model.parameters()), Adam(lr=1e-3)))
            losses[label] = [float(step(b)[0]) for b in batches]
        err = max(abs(a - b) for a, b in zip(losses["kernels"], losses["plain"]))
        res[variant] = dict(losses=losses, max_abs_loss_diff=err,
                            kernel_fwd_launches=flash_attention.fwd_launches - fwd,
                            dot_product_attention_calls=dot_product_attention.calls - dense)
    # bf16 attention rounds differently in the two versions, and four Adam
    # updates carry the difference forward: losses (about 5.5) within 2e-2.
    res["tol"] = 2e-2
    if not all(r["max_abs_loss_diff"] <= 2e-2 and r["kernel_fwd_launches"] == 4 * 2
               and r["dot_product_attention_calls"] == 0
               for r in (res["full"], res["window48"])):
        emit({"phase": "train_reference", **res})
        raise SystemExit("training through the kernels disagrees with the plain version")
    return res


# ---------------------------------------------------------- Mixtral phases

# Mixtral-8x7B widths (hidden 4096, 32 heads of 128 over 8 KV heads, 8
# experts of 14336, top 2), seeded. Serving loads 16 of the 32 layers: a
# bf16 layer holds 1.4513 B parameters (2.90 GB), 16 of them with the
# embeddings and head 46.96 GB; all 32 (93.4 GB) do not fit the 80 GB card.
MOE_LAYERS = 16
MOE_SERVE_MODEL = {"family": "mixtral", "preset": "8x7b", "seed": 0,
                   "config": {"num_layers": MOE_LAYERS}}
# Training at 1 layer: 1.7135 B parameters, 6.854 GB in f32.
MOE_TRAIN_LAYERS = 1
MOE_TRAIN_MODEL = {"model_type": "causal-lm", "family": "mixtral", "preset": "8x7b", "seed": 0,
                   "config": {"num_layers": MOE_TRAIN_LAYERS, "remat": True}}
MOE_OPTIONS = {"delta_codec": "int8"}  # 1.71 GB a push, a quarter of f32's
# A bf16 greedy split at a near-tie: the full forward's top two logits
# within this share of the top one (two to four units in the last place of
# bf16), counted beside the split rule below.
BF16_NEAR_TIE = 2.0 ** -6
# The kernel path against the plain forward routed alike: of the largest
# |logit|, as ``reference`` holds the 7B's decode forward. The 16 bf16
# layers' residual (an expert adds ~2.4 a layer at these widths) parts the
# two paths by up to 4% of the top logit (H100 80GB HBM3; PERF.md §6), so a greedy
# split is allowed where the plain forward's logit of the pool's token lies
# within this share of its top logit.
MOE_LOGIT_TOL = 0.05
MOE_PROFILE_STEP = 6  # the trainer's step (from 0) run under the profiler


@contextmanager
def router_tape(model, replay=None):
    """Forward hooks on every router of ``model``: each forward's router
    logits, layer by layer, appended to the yielded list (on the host);
    with ``replay`` (a list of per-layer logits), those replace the
    router's own, so the forward routes as the recorded one did."""
    tape: list = []

    def hook(layer, mod, args, out):
        if replay is not None:
            return replay[layer].to(out.device, out.dtype).reshape(out.shape)
        tape.append(out.detach().float().cpu())
        return None

    handles = [block.moe.gate.register_forward_hook(
        lambda mod, args, out, i=i: hook(i, mod, args, out)) for i, block in enumerate(model.layers)]
    try:
        yield tape
    finally:
        for h in handles:
            h.remove()


def routing_flips(plain: list, other: list, k: int) -> list:
    """Where two forwards of the same tokens route a token to other experts:
    (layer, row, position, the plain forward's k-th to (k+1)-th router
    probability gap), from each forward's per-layer router logits."""
    flips = []
    for layer, (a, b) in enumerate(zip(plain, other)):
        pa, pb = torch.softmax(a, -1), torch.softmax(b, -1)
        top = pa.topk(k + 1, dim=-1).values
        differ = (pa.topk(k, -1).indices.sort(-1).values != pb.topk(k, -1).indices.sort(-1).values)
        for row, t in differ.any(-1).nonzero().tolist():
            flips.append((layer, row, t, float(top[row, t, k - 1] - top[row, t, k])))
    return flips


@contextmanager
def pool_routing(model, pool):
    """The router logits of every forward the paged ``pool`` runs, filed
    under (prompt, position) of each lane the forward serves (a lane parked
    in the garbage block serves none; a decode chunk's k-th forward sits k
    positions past the lane's index): ``{(prompt tuple, position): [per-layer
    logits [E]]}``, the last computation of a position kept (a preempted
    request's recompute replaces its first)."""
    routed: dict = {}
    seen: dict = {}
    lanes: list = []

    def pre(mod, args):
        S = args[0].shape[1]
        lanes.clear()
        for slot, r in list(pool._lane_rows.items()):
            if r.slot != slot or pool._h_idx[slot] >= pool.max_len:
                continue
            key = (tuple(r.prompt), int(pool._h_idx[slot]))
            step = seen.get(slot, (None, -1))
            k = step[1] + 1 if step[0] == key and S == 1 else 0
            seen[slot] = (key, k)
            lanes.append((slot, key[0], key[1] + k, S))

    def post(mod, args, out):
        layers = tape[-len(model.layers):]
        for slot, prompt, pos, S in lanes:
            for j in range(S):
                routed[(prompt, pos + j)] = [t[slot, j] for t in layers]
        tape.clear()

    with router_tape(model) as tape:
        handles = [model.register_forward_pre_hook(pre), model.register_forward_hook(post)]
        try:
            yield routed
        finally:
            for h in handles:
                h.remove()


def pinned_splits(model, prompts: list, answers: list, routed: dict) -> tuple:
    """Each request's tokens against the plain path (one cache-less
    drop-free forward over the prompt and the pool's own tokens, routed as
    the pool routed each position): every token that is not the plain
    path's greedy one, with the plain forward's top logit there, how far
    below it the pool's token lies (``near``: within ``MOE_LOGIT_TOL`` of
    the top logit) and whether the two are its top two within
    ``BF16_NEAR_TIE``; and the positions the pool's record missed."""
    splits, missing = [], []
    for n, (prompt, toks) in enumerate(zip(prompts, answers)):
        seq = prompt + toks[:-1]
        keys = [(tuple(prompt), p) for p in range(len(seq))]
        missing += [(n, p) for (_, p) in keys if (tuple(prompt), p) not in routed]
        if any((tuple(prompt), p) not in routed for p in range(len(seq))):
            continue
        replay = [torch.stack([routed[key][layer] for key in keys])[None]
                  for layer in range(len(model.layers))]
        ids = torch.tensor([seq], device=model.device)
        with torch.inference_mode(), router_tape(model, replay):
            logits = model(ids, dropless=True)[0][0, len(prompt) - 1:].float()
        for i in (logits.argmax(-1).cpu() != torch.tensor(toks)).nonzero().flatten().tolist():
            top = logits[i].topk(2)
            head = float(top.values[0])
            lag = head - float(logits[i, toks[i]])
            tie = (int(top.indices[1]) == toks[i]
                   and float(top.values[0] - top.values[1]) <= BF16_NEAR_TIE * abs(head))
            splits.append({"request": n, "token": i, "pool": toks[i],
                           "plain": int(top.indices[0]), "top": head, "lag": lag,
                           "rank": int((logits[i] > logits[i, toks[i]]).sum()),
                           "near": lag <= MOE_LOGIT_TOL * abs(head), "bf16_tie": tie})
    return splits, missing


def serve_moe_phase() -> dict:
    """Mixtral-8x7B widths at ``MOE_LAYERS``, seeded, bf16, through the
    paged ragged pool; gates (a)-(d) as the module's docstring says."""
    from hypha_tpu_torch.executor.pool import DecodePool
    from hypha_tpu_torch.models import Mixtral
    from hypha_tpu_torch.ops.kvcache import KVCache
    from hypha_tpu_torch.worker.infer_executor import load_model

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init_s: list = []
    init = Mixtral.init_weights

    def timed_init(self, seed=0):
        t = time.perf_counter()
        out = init(self, seed)
        torch.cuda.synchronize()
        init_s.append(time.perf_counter() - t)
        return out

    Mixtral.init_weights = timed_init
    try:
        model = load_model(MOE_SERVE_MODEL)
    finally:
        Mixtral.init_weights = init
    torch.cuda.synchronize()
    load_s, load_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
    problems: list = []
    lengths, n_new = [17, 64, 130, 222, 333, 450, 599, 700], [32, 40, 48, 56, 64, 36, 44, 60]
    serve = serve_phase(model, kv_quant="", lengths=lengths, n_new=n_new)
    # (c) every forward's layers on their route: decode steps on the
    # decode kernel, prefill chunks on the mma kernel.
    fw = serve["forwards"]
    want = {"decode": fw["decode"] * MOE_LAYERS, "mma": fw["prefill"] * MOE_LAYERS, "simt": 0}
    if serve["kernel_launches_by_route"] != want or serve["plain_attention_calls"]:
        problems.append(f"(c) ragged launches {serve['kernel_launches_by_route']}, wanted {want}; "
                        f"plain attention calls {serve['plain_attention_calls']}")
    # (a) the pool's greedy tokens against the plain path's, each position
    # routed as the pool routed it: a recorded run of the same requests (the
    # timed run above keeps no hooks).
    t_check = time.perf_counter()
    prompts = serve["prompts"]
    pool = DecodePool(model, slots=8, max_len=1024, steps_per_call=8, block_size=16, ragged=True)
    try:
        with pool_routing(model, pool) as routed:
            answers = [f.result(timeout=600)[0]
                       for f in [pool.submit([p], n) for p, n in zip(prompts, n_new)]]
    finally:
        pool.close()
    same = sum(a == b[0] for a, b in zip(answers, serve["answers"]))
    splits, missing = pinned_splits(model, prompts, answers, routed)
    far = [x for x in splits if not x["near"]]
    if far or missing:
        problems.append(f"(a) {len(far)} pool tokens lie further than {MOE_LOGIT_TOL} of the top "
                        f"below the plain path's greedy token, e.g. {far[:3]}; positions "
                        f"unrecorded {missing[:4]}")
    # (b) a [8, 64] prefill chunk through the paged cache against the plain
    # forward routed as the chunk routed; unpinned, the routing flips.
    B, S = 8, 64
    k = model.config.experts_per_token
    ids = torch.tensor(make_prompts(97, [S] * B), device="cuda")
    cache = KVCache.for_model(model, B, 1024, per_row=True, blocks=64, block_size=16, ragged=True)
    cache.table[:, :4] = torch.arange(B * 4, dtype=torch.int32, device="cuda").reshape(B, 4)
    with torch.inference_mode():
        with router_tape(model) as paged_routes:
            paged = model(ids, cache)[0]
        with router_tape(model) as plain_routes:
            free = model(ids, dropless=True)[0]
        with router_tape(model, paged_routes):
            plain = model(ids, dropless=True)[0]
    flips = routing_flips(plain_routes, paged_routes, k)
    scale = float(plain.abs().max())
    err, free_err = float((paged - plain).abs().max()), float((paged - free).abs().max())
    argmax = float((paged.argmax(-1) == plain.argmax(-1)).float().mean())
    finite = bool(torch.isfinite(paged).all())
    if not finite or err > MOE_LOGIT_TOL * scale:
        problems.append(f"(b) prefill chunk logits {err} from the plain forward's routed alike "
                        f"(scale {scale}, finite {finite})")
    check_s = time.perf_counter() - t_check
    del cache, paged, plain, free
    profile = profile_phase(model)
    # A decode step reads every weight once (the embeddings' 8 rows aside).
    weight_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                       if n != "embed_tokens")
    res = {k: v for k, v in serve.items() if k not in ("prompts", "answers", "layers")}
    res.update(
        model="mixtral-8x7b", layers=MOE_LAYERS, load_s=load_s, init_s=init_s[0] if init_s else None,
        load_peak_gib=load_peak, serve_peak_gib=serve["peak_mem_gib"],
        wall_tok_s=sum(n_new) / serve["wall_s"], launches_by_route=serve["kernel_launches_by_route"],
        recorded_equal_timed=same, tokens=sum(n_new), splits=splits,
        bf16_tie_splits=sum(x["bf16_tie"] for x in splits),
        prefill_chunk={"max_abs_err": err, "scale": scale, "argmax_agreement": argmax,
                       "unpinned_flips": len(flips), "unpinned_first_flips": flips[:8],
                       "unpinned_max_abs_err": free_err},
        check_s=check_s, profile=profile,
        decode_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3, weight_bytes=weight_bytes,
        seconds=time.perf_counter() - t0,
    )
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        emit({"phase": "serve_moe", **res, "problems": problems})
        raise SystemExit("serve_moe phase failed: " + "; ".join(problems))
    return res


@contextmanager
def moe_probes(record_step=None):
    """Inside the in-process trainer: its model and θ₀'s checksum; each
    step's aux loss and per-layer ``drop_frac`` (the model's forward given
    an ``intermediates`` dict); the step numbered ``record_step`` run
    under ``record_step``'s callable; and every merge: the checksum of
    θ_t + u (each tensor added as the merge adds it, when the update is
    read) beside the anchor checksum the trainer logs after it."""
    import hypha_tpu_torch.executor.training as training
    from hypha_tpu_torch.models.convert import state_to_flat

    rec = {"model": None, "theta0": None, "aux": [], "drop_frac": [], "merges": [],
           "profiled": None}
    init, read, checksum, make = (training._init_model, training._read_update,
                                  training.theta_checksum, training.make_train_step)
    local = threading.local()

    def init_model(cfg, session, work_dir, device):
        model = init(cfg, session, work_dir, device)
        rec["model"] = model
        rec["theta0"] = checksum(state_to_flat(model, model.state_dict()))
        return model

    def read_update(path, device):
        update = read(path, device)
        model = rec["model"]
        state = model.state_dict()
        # Each tensor's bit sum after the merge, one tensor at a time (the
        # digest reads only the sums): θ_t + u, as the trainer adds it.
        with torch.no_grad():
            merged = {n: (state[n] + u.to(state[n].device, state[n].dtype)).to(state[n].dtype)
                      for n, u in update.items()}
            local.expect = checksum(state_to_flat(model, merged))
        del merged
        return update

    def merged_checksum(params):
        got = checksum(params)
        expect, local.expect = getattr(local, "expect", None), None
        if expect is not None:
            rec["merges"].append({"expected": expect, "anchor": got})
        return got

    def make_step(model, optimizer, loss, **kw):
        step = make(model, optimizer, loss, **kw)
        inter: dict = {}
        forward = model.forward

        def recorded(ids, *args, **kwargs):
            if not args and kwargs.get("cache") is None:
                kwargs.setdefault("intermediates", inter)
            return forward(ids, *args, **kwargs)

        model.forward = recorded

        def counted(batch):
            if len(rec["aux"]) == MOE_PROFILE_STEP and record_step is not None:
                out, rec["profiled"] = record_step(lambda: step(batch))
            else:
                out = step(batch)
            rec["aux"].append(float(out[2]))
            rec["drop_frac"].append({k: float(v) for k, v in inter.items()})
            return out

        return counted

    training._init_model, training._read_update = init_model, read_update
    training.theta_checksum, training.make_train_step = merged_checksum, make_step
    try:
        yield rec
    finally:
        training._init_model, training._read_update = init, read
        training.theta_checksum, training.make_train_step = checksum, make


def profiled_step(fn) -> tuple:
    """``fn()`` under the profiler: its result, and the host ms, the
    device's busy ms (kernels' own time), the idle share and the top
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    flash = {name: {"ms": sum(ms for k, ms, _ in rows if name in k),
                    "launches": sum(c for k, _, c in rows if name in k)} for name in FLASH_NAMES}
    return out, dict(wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall, flash=flash,
                     top=[{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in rows[:10]])


async def run_moe_job(root: Path, model: dict, *, device, rounds, steps, batch, seq, period,
                      status_timeout=None, sample_card=False, record_step=None) -> dict:
    """``run_node_job`` of one in-process trainer with ``MOE_OPTIONS``,
    under ``moe_probes`` (``record_step`` runs one step, as
    ``profiled_step`` does); the probes' record under ``moe``."""
    with moe_probes(record_step) as mrec:
        run = await run_node_job(root, model, device=device, rounds=rounds, steps=steps,
                                 batch=batch, seq=seq, period=period, workers=1,
                                 train_runtime="in-process", status_timeout=status_timeout,
                                 job_options=MOE_OPTIONS, sample_card=sample_card)
    return {**run, "moe": mrec}


def moe_train_problems(run: dict, *, rounds: int, theta0: str, launches: dict,
                       batches: int, layers: int, device: str) -> list:
    """Gates (a)-(f) of ``train_moe`` (the module's docstring):
    ``node_problems`` holds (a), (f) and (d), every Δθ frame carrying each
    flat name of the config at its shape (the experts' ``[8, 4096, 14336]``
    / ``[8, 14336, 4096]`` and the router's ``[4096, 8]`` among them)."""
    mrec = run["moe"]
    cfg = mrec["model"].config if mrec["model"] is not None else None
    problems = node_problems(run, rounds=rounds, expect=flat_f32_spec(run["job"].model))
    bound = cfg.router_aux_coef * cfg.num_experts if cfg is not None else 0.0
    if len(mrec["aux"]) != batches or not all(math.isfinite(a) and 0.0 <= a <= bound
                                              for a in mrec["aux"]):
        problems.append(f"(b) aux losses {mrec['aux']}: wanted {batches}, each finite in "
                        f"[0, {bound}]")
    if device != "cpu":
        want = {"fwd": 2 * layers * batches, "dq": layers * batches, "dkv": layers * batches,
                "flash_plain": 0}
        if launches != want:
            problems.append(f"(c) flash launches {launches}, wanted {want}")
    if mrec["theta0"] != theta0:
        problems.append(f"(e) the trainer's θ₀ {mrec['theta0']}, the seed's {theta0}")
    merges = mrec["merges"]
    if len(merges) != rounds or any(m["expected"] != m["anchor"] for m in merges):
        problems.append(f"(e) merges {merges}: wanted {rounds}, each θ_t + u")
    return problems


def train_moe_phase() -> dict:
    """Mixtral-8x7B widths at ``MOE_TRAIN_LAYERS`` trained as one blocking
    int8 DiLoCo job; gates (a)-(f) as the module's docstring says."""
    from hypha_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    theta = ThetaTrack(MOE_TRAIN_MODEL, "cuda")
    theta0 = theta.checksum(theta.theta0)
    n_params = sum(t.numel() for t in theta.theta0.values())
    del theta
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    root = Path(tempfile.mkdtemp(prefix="hmo"))
    flash_attention.fwd_launches = flash_attention.dq_launches = 0
    flash_attention.dkv_launches = flash_attention.plain_calls = 0
    try:
        run = asyncio.run(run_moe_job(
            root, MOE_TRAIN_MODEL, device="cuda", rounds=TRAIN_ROUNDS, steps=TRAIN_STEPS,
            batch=TRAIN_BATCH, seq=TRAIN_SEQ, period=TRAIN_PERIOD,
            status_timeout=NODE_STATUS_TIMEOUT_S, sample_card=True, record_step=profiled_step))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {"fwd": flash_attention.fwd_launches, "dq": flash_attention.dq_launches,
                "dkv": flash_attention.dkv_launches, "flash_plain": flash_attention.plain_calls}
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec, mrec, result = run["rec"], run["moe"], run["result"]
    batches = sum(p["kind"] == "status" for p in rec["progress"])
    problems = moe_train_problems(run, rounds=TRAIN_ROUNDS, theta0=theta0, launches=launches,
                                  batches=batches, layers=MOE_TRAIN_LAYERS, device="cuda")
    mrec["model"] = None
    timing = progress_timing(run)
    step_ms = timing["step_ms"]
    gb = n_params * 4 / 1e9
    res = dict(
        model="mixtral-8x7b", layers=MOE_TRAIN_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
        rounds=TRAIN_ROUNDS, steps=TRAIN_STEPS, codec=MOE_OPTIONS["delta_codec"],
        parameters=n_params, jobs=run["jobs"],
        losses=[(w, r, m.get("loss")) for w, r, m in result.metrics],
        aux=mrec["aux"], drop_frac=mrec["drop_frac"],
        step_ms=step_ms, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3) if step_ms else None,
        round_boundary_s=timing["round_boundary_s"],
        delta_push=rec["push"], broadcast=rec["broadcast"], fold_s=rec["fold_s"],
        outer_step_s=rec["outer_step_s"], encode_s=rec["encode_s"],
        delta_bytes=[d["bytes"] for d in rec["deltas"]],
        launches=launches, merges=mrec["merges"], theta0=theta0,
        # p, g, m, v, the anchor and the int8 error feedback of the trainer,
        # the server's f32 sum: 7 f32 copies of the parameters, before
        # activations and the merge's decoded update.
        estimated_peak_gb=7 * gb, peak_gib_process=peak, card_peak_mib=run["card_peak_mib"],
        profiled_step=mrec["profiled"], first_beat_s=run["first_beat_s"],
        seconds=time.perf_counter() - t0)
    if problems:
        emit({"phase": "train_moe", **res, "problems": problems})
        raise SystemExit("train_moe phase failed: " + "; ".join(problems))
    return res


# ---------------------------------------------------------- a phase beside

# ``train_ft`` spends most of its wall on the disk (5.6 GB server
# checkpoints, each round's f32 state files) and on its faults' timers
# (leases, the spare's bring-up, the restarts), with 2-3 trainers on the
# card. It runs as a child process (``python3 chip_smoke.py --phase
# train_ft``) beside the serving network phases, ``train`` and
# ``train_node``, whose processes leave the card's memory to it (each
# under 20 GiB against its 44 GiB), and is joined before ``serve_moe``.
CHILD_PHASES = ("train_ft",)
CHILD_LIMIT_S = 900.0  # the child's wall, its own phase deadline included


class ChildPhase:
    """``name`` run by ``python3 chip_smoke.py --phase name`` beside this
    process's phases, its output in files of the temporary directory.
    ``join`` waits for it and returns its line, with when it started,
    ended and how long this process waited; a child that fails fails the
    smoke with the tail of its output."""

    def __init__(self, name: str) -> None:
        self.name = name
        fd, out = tempfile.mkstemp(prefix=f"chip-smoke-{name}-", suffix=".out")
        os.close(fd)
        self.out, self.err = Path(out), Path(out).with_suffix(".err")
        self.started_at_s = time.perf_counter() - _T0
        here = Path(__file__).resolve()
        # A session of its own: a smoke that fails or is sent SIGTERM while
        # it runs ends the child and every node and trainer process under
        # it (``atexit``).
        with open(self.out, "wb") as stdout, open(self.err, "wb") as stderr:
            self.proc = subprocess.Popen([sys.executable, str(here), "--phase", name],
                                         stdout=stdout, stderr=stderr, cwd=str(here.parent),
                                         start_new_session=True)
        atexit.register(self._kill)
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))

    def _kill(self) -> None:
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.proc.wait()

    def join(self) -> dict:
        t0 = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=max(1.0, CHILD_LIMIT_S - (t0 - _T0 - self.started_at_s)))
        except subprocess.TimeoutExpired:
            self._kill()
            rc = "killed at its limit"
        waited = time.perf_counter() - t0
        text = self.out.read_text(errors="replace")
        tail = self.err.read_text(errors="replace")[-6000:]
        self.out.unlink(missing_ok=True)
        self.err.unlink(missing_ok=True)
        lines = [json.loads(x) for x in text.splitlines() if x.startswith('{"phase": ')]
        mine = [x for x in lines if x.get("phase") == self.name]
        if rc != 0 or not mine:
            for x in lines:
                emit(x)
            raise SystemExit(f"{self.name} (child process) exited {rc}:\n{tail}")
        res = {k: v for k, v in mine[-1].items() if k not in ("phase", "at_s")}
        res["child"] = {"started_at_s": self.started_at_s, "ended_at_s": mine[-1]["at_s"]
                        + self.started_at_s, "join_wait_s": waited}
        return res


def run_child_phase(name: str) -> int:
    """The child's side: one phase of ``CHILD_PHASES``, its line, and its
    background removals awaited before it exits."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hypha_tpu_torch.ops._build import build

    bytecode_cache()
    build()  # the parent built every kernel: this loads them
    res = {"train_ft": train_ft_phase}[name]()
    emit({"phase": name, **res, "removals": await_removals()})
    return 0


def bytecode_cache() -> str:
    """One bytecode cache for this process and every process it starts
    (nodes, trainers), in the checkout's build directory. The card's
    machine runs Python with PYTHONDONTWRITEBYTECODE and its packages ship
    no bytecode, so every process compiled torch anew (7-8.5 s of each
    start; 4.2-5.1 s with the cache)."""
    prefix = str(Path(__file__).resolve().parent / "hypha_tpu_torch" / "ops" / "_build" / "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    sys.dont_write_bytecode = False
    sys.pycache_prefix = prefix
    return prefix


def main() -> int:
    if sys.argv[1:2] == ["--phase"] and len(sys.argv) == 3 and sys.argv[2] in CHILD_PHASES:
        return run_child_phase(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hypha_tpu_torch.ops._build import build
    from hypha_tpu_torch.worker.infer_executor import load_model

    pycache = bytecode_cache()

    smi = nvidia_smi()
    t_start = time.perf_counter()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "pycache": pycache})

    t0 = time.perf_counter()
    built = build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {k: {"seconds": v["seconds"], "cached": v["cached"], "ptxas": ptxas(v["log"])}
                      for k, v in built.items()}})

    kern = kernel_phase()
    flash = flash_kernel_phase()

    t0 = time.perf_counter()
    model = load_model({"family": "llama", "preset": "llama2-7b", "seed": 0})
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    lengths, n_new = [17, 64, 130, 222, 333, 450, 599, 700], [32, 40, 48, 56, 64, 36, 44, 60]
    serve = serve_phase(model, kv_quant="", lengths=lengths, n_new=n_new)
    hidden = ("prompts", "answers", "layers")
    emit({"phase": "serve", "model": "llama2-7b", "load_s": load_s,
          **{k: v for k, v in serve.items() if k not in hidden}})
    emit({"phase": "profile", **profile_phase(model)})
    emit({"phase": "reference", **reference_phase(model)})
    del model  # free the serving model: the worker of serve_node and training take the card
    gc.collect()
    torch.cuda.empty_cache()
    # The network's serving phases and their in-process references run at
    # CLI_LAYERS; serve_prefix too, whose cached bf16 answers serve_router
    # and serve_fleet are held to.
    t0 = time.perf_counter()
    cli = load_model(CLI_MODEL)
    serve_cli = serve_phase(cli, kv_quant="", lengths=lengths, n_new=n_new)
    emit({"phase": "serve_cli_reference", "layers": CLI_LAYERS,
          "seconds": time.perf_counter() - t0,
          **{k: v for k, v in serve_cli.items() if k not in hidden}})
    serve8 = serve_phase(cli, kv_quant="int8", lengths=[25, 180, 410, 650], n_new=[32, 48, 40, 64])
    emit({"phase": "serve_int8", "layers": CLI_LAYERS,
          **{k: v for k, v in serve8.items() if k not in hidden}})
    prefix = serve_prefix_phase(cli)
    emit({"phase": "serve_prefix", **{k: v for k, v in prefix.items() if k not in hidden}})
    spec = serve_spec_phase(cli)
    emit({"phase": "serve_spec", **spec})
    traffic = fleet_traffic()
    fleet_ref = {**fleet_reference(cli, traffic), "traffic": traffic}
    del cli
    gc.collect()
    torch.cuda.empty_cache()
    # train_ft in a child process beside the next five phases.
    ft_child = ChildPhase("train_ft")
    serve_node = serve_node_phase(serve_cli)
    emit({"phase": "serve_node", **serve_node})
    serve_router = serve_router_phase(prefix)
    emit({"phase": "serve_router", **serve_router})
    serve_fleet = serve_fleet_phase(fleet_ref, prefix)
    emit({"phase": "serve_fleet", **serve_fleet})
    train = train_phase()
    emit({"phase": "train", **train})
    emit({"phase": "train_node", **train_node_phase(train)})
    ft = ft_child.join()
    emit({"phase": "train_ft", **ft})
    serve_moe = serve_moe_phase()
    emit({"phase": "serve_moe", **serve_moe})

    data = train_data_phase()
    emit({"phase": "train_data", **data})
    stream = train_stream_phase()
    emit({"phase": "train_stream", **stream})
    emit({"phase": "train_secure", **train_secure_phase(stream)})
    shard = train_shard_phase()
    emit({"phase": "train_shard", **shard})
    shard_ft = train_shard_ft_phase()
    emit({"phase": "train_shard_ft", **shard_ft})
    het = train_het_phase()
    emit({"phase": "train_het", **het})
    swap = train_swap_phase()
    emit({"phase": "train_swap", **swap})
    lora = train_lora_phase()
    emit({"phase": "train_lora", **lora})
    lora7 = lora_7b_phase()
    emit({"phase": "lora_7b", **lora7})
    train_moe = train_moe_phase()
    emit({"phase": "train_moe", **train_moe})
    emit({"phase": "train_reference", **train_reference_phase()})
    # The fault phases' roots, removed while later phases ran.
    emit({"phase": "removals", "removals": await_removals()})

    dec, pre = kern["timing"]["decode_bf16"], kern["timing"]["prefill64_bf16"]
    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": serve["kernel_launches"],
        "max_abs_err": kern["max_abs_err"], "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        # The decode shape above (decode route, L2-cold) with the simt and
        # mma routes on the same inputs, the prefill-chunk shape here (mma
        # route), and the serve run's launches split by route.
        "decode_simt_ms": dec["simt_ms"], "decode_mma_ms": dec["mma_ms"],
        "decode_splits": dec["decode_splits"],
        "launches_by_route": serve["kernel_launches_by_route"],
        # The same requests through the network, counted by the worker,
        # and serve_prefix's through the router, counted by each backend.
        "serve_node_launches": serve_node["launches"],
        "serve_router_launches": {role: w["launches"]
                                  for role, w in serve_router["workers"].items()},
        "serve_fleet_launches": serve_fleet["launches"],
        # The follower of train_swap, counted in process over the job.
        "train_swap_launches": swap["launches"],
        # train_lora's folded model serving its greedy tokens.
        "train_lora_fold_launches": lora["fold"]["launches_by_route"],
        # serve_spec's paged runs: the pool's and the self-draft's own.
        "serve_spec_launches": {name: r["launches_by_route"]
                                for name, r in spec["runs"].items() if "fixed" not in name},
        "serve_spec_draft_launches": spec["runs"]["bf16_layers"]["draft_launches_by_route"],
        "serve_spec_profiled": {name: r["kernels"] for name, r in spec["profiled"].items()},
        # Mixtral-8x7B widths at 16 layers through the pool, by route.
        "serve_moe_launches": serve_moe["launches_by_route"],
        "prefill64_ms": pre["ms"], "prefill64_simt_ms": pre["simt_ms"],
        "prefill64_plain_ms": pre["plain_ms"], "prefill64_bound_ms": pre["bound_ms"],
        "prefill64_bound_by": pre["bound_by"], "prefill64_library_ms": pre["library_ms"],
    }]
    for (name, replaces), key in zip(FLASH_REPLACES.items(), ("fwd", "dq", "dkv")):
        t = flash[key]
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE, "replaces": replaces,
            "launches": train["kernel_launches"][key], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            # The fault-tolerant job's trainers, each counted by its process.
            "train_ft_launches": {peer: (t_["launches"] or {}).get(key)
                                  for peer, t_ in ft["trainers"].items()},
            # The sharded jobs' trainers, each counted by its process.
            "train_shard_launches": {
                job: {peer: (launches or {}).get(key)
                      for peer, launches in shard[job]["attention_launches"].items()}
                for job in ("job_S", "job_B")},
            # The fault-tolerant sharded job's trainers, the rejoiner included.
            "train_shard_ft_launches": {peer: (t_["launches"] or {}).get(key)
                                        for peer, t_ in shard_ft["trainers"].items()},
            # The adaptive job's trainers, each counted by its process.
            "train_het_launches": {peer: (t_["launches"] or {}).get(key)
                                   for peer, t_ in het["trainers"].items()},
            # The broadcast-tree job's surviving trainers (w0 is killed).
            "train_swap_launches": {peer: (t_["launches"] or {}).get(key)
                                    for peer, t_ in swap["trainers"].items() if peer != "w0"},
            # The input pipeline's runs: part (a)'s pipelined run in process,
            # part (b)'s trainers, each counted by its process.
            "train_data_launches": {
                "local_pipelined": data["local"]["pipelined"]["launches"][key],
                **{peer: (t_["launches"] or {}).get(key)
                   for peer, t_ in data["network"]["trainers"].items()}},
            # The LoRA jobs: both in-process trainers together, and the 7B.
            "train_lora_launches": lora["launches"][key],
            "lora_7b_launches": lora7["launches"][key],
            # Mixtral-8x7B widths at 1 layer, its in-process trainer.
            "train_moe_launches": train_moe["launches"][key],
        })
    seed = lora7["init"]["kernel"]
    kernels.append({
        "name": "seed_init_draw", "route": "cuda", "source": SEED_SOURCE,
        "replaces": SEED_REPLACES, "launches": lora7["init"]["launches"],
        "max_abs_err": seed["max_abs_err"], "ms": seed["ms"], "plain_ms": seed["plain_ms"],
        "bound_ms": seed["bound_ms"], "bound_by": seed["bound_by"], "library_ms": None,
        # No Pallas kernel: model.init draws with XLA. The whole 7B's init
        # beside the torch.Generator init it replaced, and the CPU's check.
        "shape": seed["shape"], "init_s": lora7["init"]["seconds"],
        "generator_init_s": lora7["init"]["generator_seconds"],
        "checked_elements": lora7["init"]["check"]["elements"],
    })
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
