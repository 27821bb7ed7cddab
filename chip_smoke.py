#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``olearning_sim_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):

1. The card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``.
2. Build every kernel under ``olearning_sim_tpu_torch/csrc`` with ``nvcc``
   through ``ops._build.build_all`` (one process per source, all started
   together; the GPU image's build step) and print the build time.
3. Kernel phase: each kernel (K1 ``flash_attention``, K2
   ``flash_attention_stats``) against its plain PyTorch version on the card,
   at its path's shape and at ragged, multi-tile and masked shapes, in bf16
   and f32, with the tolerance stated (both run the wgmma + TMA kernel
   template, f32 in split-precision TF32, three TF32 products per k-step);
   K2's stats over two K/V halves, folded by the ring merge, against the
   whole; then, per input type at each path's shape, kernel, plain and
   library times (the library's backend named) beside the card's least
   possible time (the bound: bf16 operations at the bf16 tensor-core peak,
   f32 three TF32 products at the TF32 peak) and the roofline share.
4. Main path: two full-width DistilBERT FedAdam rounds (768/12/6/3072,
   vocab 30522, L 64; dense attention) on 16 synthetic clients, then
   ``evaluate`` on 2048 held-out rows (their tails padded from PAD_SEED).
5. Flash evaluate: phase 4's model and clients trained from the initial
   parameters for FLASH_TRAIN_ROUNDS rounds at a local lr of
   WITNESS_LOCAL_LR (the config's diverges at this width),
   its q/k/v stacked into the flash layout (``dense_to_flash``), evaluated
   with ``attention_impl="flash"`` on the 2048 rows, which must launch K1 6
   times per eval batch; held by its logits: within EVAL_LOGITS_ATOL of the
   dense model's (its loss within EVAL_LOSS_TOL), the same check failing K1
   with its key mask dropped and with uniform weights, and one eval batch's
   logits and loss against the CPU path (plain version).
6. Long-context path: full-width DistilBERT with ``attention_impl="ring"``,
   ``ring_use_flash=True`` and ``max_len=2048`` on a ring of one (one card),
   on 8 synthetic rows of 2048 tokens with padded tails: two forwards, whose
   logits must agree with the dense-combine ring model's, and one SGD step
   whose gradients must agree with the dense-combine step's; K2 must launch
   6 times per forward.

7. Headline families (no kernel of the repo is on this path: ``mlp2`` and
   ``cnn4`` are torch convolutions, matrix products and elementwise ops, as
   the JAX package leaves them to XLA), each at its task config's
   population and published width, seed 0:
   7a ``fedavg_mnist_mlp``: mlp2 784-200-10, 100 IID clients (n_local 64,
      class_sep 2.0), block 32, batch 32, 10 local steps, FedAvg lr 0.05,
      3 rounds, ``evaluate`` on 1024 rows;
   7b ``fedavg_cifar10_cnn``: cnn4 (32/64/128) at 32x32x3, 1000 clients
      (n_local 50, Dirichlet 0.5), block 128, 3 rounds, 2048 eval rows;
   7c ``scaffold_mnist_mlp``: SCAFFOLD at 7a's population, 2 rounds; the
      server control must be finite and non-zero;
   7d FedProx (mu 0.1, lr 0.03) on cnn4 at 7b's population, 2 rounds;
   7e Ditto (lam 0.1, lr 0.03, bf16 personal params) on mlp2 at 7a's
      population with local steps 8 / 5 / 2 over thirds of the clients,
      2 rounds, then ``evaluate_personal``;
   7f ``fedavg_mnist_mlp_bf16``: 7a with the bf16 local-SGD carry, 2 rounds;
   then one FedAvg round of cnn4, two SCAFFOLD rounds (the second applies
   the correction g + c - c_i) and one Ditto round of mlp2 on 8 clients,
   each on the card and on the CPU with the same indices, held against
   each other.

8. The task path (no kernel of the repo is on it either): task JSONs from
   ``configs/`` through ``build_runner_from_taskconfig(..., device=dev)``
   and the runner's ``begin``/``step``/``finish`` (what ``run()`` is), at
   each config's published width, cut only in rounds and, for DistilBERT,
   clients and the block of clients, by editing the loaded JSON (never the
   file); each cut is printed:
   8a ``fedavg_mnist_mlp`` uncut but for rounds (3 of 50), train + evaluate;
   8b ``fedavg_cifar10_cnn`` (2 of 100 rounds); 8c ``scaffold_mnist_mlp``
   (2 of 50); 8d ``fedadam_sent140_distilbert`` at full width, clients
   10,000 -> 64, 2 of 200 rounds, its flow_dispatch strategy (sine
   release, drop probability 0.05) live; its block of clients is cut from
   64 to DISTILBERT_BLOCK, since one block of 64 does not fit the card.
   Each prints steady rounds/sec, the per-phase times from the runner's own
   ``ols_engine_round_phase_duration_seconds`` series, every round's
   released/dropped/clients_trained/mean_loss/eval loss and accuracy, and
   the task row's ``logical_result``. Then:
   8e 8a's rounds driven directly with ``core.round_step`` from the same
      seed, with the participation masks of ``compile_trace``: final params
      within RUNNER_DIRECT_REL of 8a's;
   8f 8a's task with ``{"resilience": {"failure_policy": "retry"}}``, run
      twice: with ``runner.round_begin`` armed once at round 1 (the attempt
      fails before it trains) and with ``runner.pre_checkpoint`` (a host
      preemption after the attempt has trained and advanced the round
      counter its minibatch draws are seeded from). Each run completes
      with exactly one rollback and final params within RETRY_REL of 8a's;
      the second holds only if the snapshot restored the round counter;
   8g 8a's task, train operator only, with ``quarantine_after: 1`` and
      ``runner.poison_clients`` armed for clients [3, 7, 11] at round 0:
      those three are failed in ``logical_result``, excluded from
      ``clients_trained`` and are the clients the quarantine holds, and the
      params stay finite.
   Then checkpoints, model files and convergence, every file under a
   ``tempfile.TemporaryDirectory`` removed at the end (and a line saying
   whether ``msgpack`` imports here, which the port does not use):
   8h 8a's task with ``{"checkpoint": {"every": 1}}``, stopped (the
      runner's stop event) after round 0 and resumed by a fresh runner from
      the same JSON and directory: final params within RETRY_REL of 8a's;
      then with ``{"failure_policy": "retry"}`` and a preemption at
      ``runner.pre_checkpoint`` in round 2 (one rollback, recovered through
      one restore), and the same with ``checkpoint.corrupt`` tearing round
      1's step (one ``checkpoint_fallback``, rounds 1-2 replayed): each
      within RETRY_REL of 8a's;
   8i 8d's task (full-width DistilBERT FedAdam, 64 clients, block
      DISTILBERT_BLOCK) with a checkpoint every round, stopped after round
      0 and resumed: params and both Adam moments within RETRY_REL of 8d's;
      the save and restore seconds and bytes per step from the runner's
      ``ols_checkpoint_*`` series, the steps' sizes on disk and the peak
      device memory printed;
   8j 8d's task with ``model_update_style``: each round's model file size
      and the ``model_export`` phase time printed; a fresh runner with
      ``use_model`` and ``model_path`` = the round-1 file holds exactly
      those params (max abs difference 0);
   8k 8a's task exporting each round; the round-2 file deleted, a fresh
      runner resumes from the round-1 file and runs round 2: final params
      within RETRY_REL of 8a's;
   8l ``fedavg_mnist_mlp_convergence`` cut to 10 of 50 rounds: its
      convergence record (eval points at rounds 4 and 9); then stopped
      after round 5 and resumed by a fresh runner: the identical record
      under ``strip_wall``.

9. Deadline rounds, client attacks and the defense (no kernel of the repo
   is on this path either: the robust statistics are ``torch.sort`` and
   elementwise ops, as the JAX package leaves them to XLA), through the
   bridge and runner at the configs' published width, cut only in rounds
   (6 of 50):
   9a ``fedavg_mnist_mlp_deadline``: every round's selected, on_time,
      stragglers, deadline_s, round_close_s and idle_s, the rounds/sec and
      the phase times; held: round 0 equals a direct ``round_step`` with
      the on-time mask that the pacing module plans (bitwise), a
      ``runner.straggler_spike`` round records ``deadline_miss`` and is
      skipped, and a run stopped after round 2 and resumed by a fresh
      runner equals the uninterrupted run bitwise, pacing states included;
   9b ``fedavg_mnist_mlp_defense`` (preseed [1, 3]) under
      ``runner.attack_clients`` ``scale`` -8 on ATTACKERS every round,
      beside a clean and an attacked undefended run (final eval losses
      printed): every round's clipped, flagged and quarantined clients and
      the robust statistics' milliseconds (CUDA events around each call),
      the [C, P] delta buffer's bytes and the peak memory; held: round 0's
      aggregate, median centre and scores against a float64 numpy oracle
      over the same buffer (ORACLE_RTOL), every attacker quarantined by
      the round ``quarantine_after`` allows, and a run preempted after
      round 2 trained, recovered from its checkpoint under a retry policy,
      equal to the uninterrupted run bitwise, quarantine state included.

10. The remaining families (no kernel of the repo is on this path:
    ``resnet18`` is torch convolutions, GroupNorm and ReLU; ``vit_tiny``
    and ``moe_text`` use dense attention, as the JAX package leaves them
    to XLA):
    10a ``fedprox_femnist_resnet18`` through the bridge and runner, train
       and evaluate, at published width with its block of 64 and its
       ``exp(-t/30)`` flow_dispatch strategy live; clients cut 3,500 ->
       128 (RESNET_CLIENTS), 2 of 100 rounds;
    10b ``ditto_cifar100_vit`` likewise, block 32, bf16 personal params,
       compute profiles 8/5/2 steps; clients cut 10,000 -> 128
       (VIT_CLIENTS, the config's 3:4:3), 2 of 100 rounds; then
       ``evaluate_personal`` and the personal state's bytes per client;
    10c ``moe_text`` at its registry defaults (vocab 30522, width 256,
       depth 4, 8 heads, MLP 512, 8 experts, L 64) through
       ``build_fedcore``: FedAvg lr 0.05, aux_loss_weight 0.01, MOE_CLIENTS
       synthetic text clients, block 16, batch 16, 2 steps, 2 rounds, then
       ``evaluate`` (eval batch MOE_EVAL_BATCH) and the aux loss's value;
    10d each family on 8 clients, one round, on the card and on the CPU
       with the same indices: in f32 compute within FAMILY_F32_REL, in
       bf16 the card's move no farther from the CPU's f32 move than
       BF16_NOISE_RATIO times the CPU's bf16 move;
    10e one round of 10a under ``torch.profiler``: kernel launches, device
       busy ms, the idle share and the top 5 kernels.

11. Scenario traces and block-streamed rounds (no kernel of the repo is on
    this path either: mlp2 as in phase 7, the staging is copies), through
    the bridge and runner at ``fedavg_mnist_mlp_trace``'s published width
    (mlp2 784-200-10, block 32, its scenario live: diurnal phase per device
    class, the spike at rounds 8-10, churn, joins, label drift):
    11a its 100 clients streamed in one block of ``stream_block_rows``
       2048, 3 of 50 rounds: per round the scenario's counts, clients
       trained, the ``stream`` record, the phase times and the step's peak
       device memory; held bitwise against the same task run resident (the
       JSON without ``stream_block_rows``);
    11b clients 100 -> STREAM_CLIENTS (two stream blocks), 1 round
       streamed and 1 resident, held bitwise (11a and 11c carry streamed
       state across rounds); the stream records'
       transfer bytes, waits and overlap, both runs' peak memory; then one
       streamed round with the staging thread and one without, in turns
       (held bitwise against each other);
    11c 11a with a checkpoint every round, a host preemption at round 2's
       start ending the run, and a fresh runner over the same directory:
       bitwise equal to 11a.

12. Buffered async rounds, the sharded server update and the multi-task
    dispatcher (no kernel of the repo is on this path either: the window
    sums are a matrix product, the commits elementwise), through the bridge
    and runner at the configs' published width and population:
    12a ``fedavg_mnist_mlp_async`` (mlp2 784-200-10, 100 clients in two
       classes, block 32, M 25, max_staleness 8, polynomial alpha 0.5), 3
       of 50 rounds: per round the async accounting (commits, committed,
       stale-dropped, windows, idle and close seconds, the commit clock),
       the phase times and the peak device memory; run twice on the card
       (bitwise: no atomics in the window sums) and once on the CPU (host
       outputs exact, the move within CARD_CPU_REL);
    12b 12a's JSON edited to max_staleness 1 and the score schedule, with a
       trimmed mean with anomaly scores and ATTACK_PLAN's scale -8 attack,
       2 rounds on the card and on the CPU: stale-dropped equal to the
       plan's count, host outputs exact, the move and the scores within
       CARD_CPU_REL;
    12c 12a with a checkpoint every round, preempted at round 2's start and
       resumed by a fresh runner: bitwise 12a, the commit clock included;
    12d ``fedavg_mnist_mlp_bf16`` whole (shard_server_update true), 3 rounds,
       bitwise the same JSON with the key false; then one FedAdam round of
       it each way, its flat moments bitwise the replicated ones;
    12e 12a's task and ``fedavg_mnist_mlp``, 3 rounds each, solo back to
       back, then under ``MultiTaskDispatcher`` in turns and on threads
       with a task repo holding the leases: each task bitwise its solo run,
       every lease released; the aggregate rounds/sec of each mode; then
       two ``fedavg_mnist_mlp`` tasks sharing one FedCore on threads, each
       bitwise its solo run.

13. Data parallelism over ``torch.distributed`` (no kernel of the repo is
    on this path: the collectives are NCCL's and gloo's):
    13a an NCCL group of one rank (``init_method`` tcp on localhost): phase
       4's DistilBERT round, 8a, 9b (its attack), 11a, 12a and 12d
       (sharded) rerun through the same entry points, each bitwise its
       earlier run with no group, with the bytes each collective is handed
       per round and phase 4's rounds/sec under the group against none;
       then the group is destroyed;
    13b two ranks on the one card over gloo (NCCL refuses two ranks on one
       card), spawned: ``fedavg_mnist_mlp``, ``_defense`` under 9b's
       attack, ``_async``, ``_bf16`` sharded and replicated, and 12c's
       preempted async run resumed, through the bridge (its plan over
       both ranks): the ranks' records and params equal; 9b bitwise dp 1's
       (quarantine included), 12d sharded bitwise replicated, the resume
       bitwise the uninterrupted dp-2 run, the mean-aggregated runs within
       DP_PARAM_ATOL of dp 1's; 9b's peak memory per rank at dp 1 and 2,
       and the gloo rounds/sec (through the host: not a speed of the port).

14. Model parallelism over two ranks on the one card, over gloo, spawned
    as 13b, each against the same work at mp 1 (pp 1, ep 1) on the card:
    14a ``fedadam_sent140_distilbert_mp2`` through the bridge (clients cut
       to 32, block to 16, one round): the ranks' records and params
       equal, the round's move within MP_MOVE_REL of mp 1's, the per-rank
       peak device memory at mp 1 and mp 2 and the bytes handed to each
       collective;
    14b a flash evaluate at mp 2 (attention whole, FFN split) of phase 5's
       model on phase 5's rows: K1 launched depth x batches times on each
       rank (counted from 0 on each), the loss within EVAL_LOSS_TOL of mp
       1's, the logits within EVAL_LOGITS_ATOL of mp 1's, and the same check
       failing K1 with its key mask dropped and with uniform weights;
    14c a pp-2 round of full-width DistilBERT (GPipe, M 2): the ranks
       equal, the move within MP_MOVE_REL of the dense round's;
    14d ``ep_train_step`` of ``moe_text`` at ep 2: the move within
       MP_MOVE_REL of the dense step's.

15. The port's control plane (no kernel of the repo is on this path; K1
    and K2 stay held by the earlier phases), its modules only:
    15a a ``TaskManager`` over a ``SqliteTableRepo`` task table in a
       temporary directory, a ``SqliteQueueRepo`` intake, a
       ``ResourceManager`` over ``DeviceTopology.detect(dev,
       units_per_core=U)`` and a ``PerformanceManager``, driven by hand
       (``drain_intake_once`` / ``schedule_once`` / ``release_once``):
       ``fedavg_mnist_mlp`` (3 rounds, priority 1) and
       ``fedadam_sent140_distilbert`` at full width cut as 8d is (64
       clients, block DISTILBERT_BLOCK, 2 rounds, priority 9), pushed on the
       intake in that order; U is the phase's total request, so both are
       admitted and run at once on the manager's threads. Held: both rows
       SUCCEEDED with ``logical_round`` their rounds, the higher priority
       scheduled first, and each task's final params bitwise the same task
       built with ``build_runner_from_taskconfig(..., device=dev)`` and run
       directly. Printed: each task's queue wait, its job's seconds from
       launch to end, and runner rounds/sec through the manager beside the
       direct run's (both from a performance manager's rows);
    15b before the release: ``PerformanceManager.render_metrics()`` holds
       both tasks' ``ols_engine_round_phase_duration_seconds`` series and
       the ``ols_taskmgr_*`` series; a ``MetricsHTTPServer`` on
       127.0.0.1:0, scraped once with ``urllib``, returns the render byte
       for byte; ``start_trace`` / ``stop_trace`` around the second round of
       a 2-round mlp2 task leave a Chrome trace holding CUDA kernel events
       (counted) and ``runner_spans.trace.json``;
    15c an mlp2 task of 6 rounds with a checkpoint every round under a
       manager over a SQLite file, whose runner dies after round 2 (no
       fence, no release, the lease left to expire, as a crash would); a
       ``TaskSupervisor`` over the same file scans past the lease's expiry
       (``now=``), reclaims the task, resumes it from its checkpoint on the
       card and finishes it. Held: the final params bitwise the
       uninterrupted run's, ``ols_supervisor_resumes_total`` 1. Printed:
       the seconds from the reclaim to the first resumed round.
    The phase's series go to a fresh process-default registry (the
    manager's ``ols_taskmgr_*`` series are the default registry's, as in
    the JAX package), the previous one restored after.

16. The platform, the chip-pool scheduler and the deviceflow service (no
    kernel of the repo is on this path either):
    16a ``python -m olearning_sim_tpu_torch --config <tmp>/platform.ini`` in
       a subprocess on the card, its INI naming the services taskmgr,
       resourcemgr, deviceflow, phonemgr, slicemgr and performancemgr, a
       SQLite file and an intake queue; ``fedavg_mnist_mlp`` cut to
       PLATFORM_ROUNDS rounds with its train operator's behaviour
       controller on (PLATFORM_FLOW, 20 released a round) pushed onto the
       intake, exporting its model file each round. Held: the row
       SUCCEEDED with its rounds, the task's deviceflow registration held
       while it ran and dropped with its flows at the release (the release
       waits for ``check_dispatch_finished``), exit 0 on SIGTERM, and the
       row's ``logical_result`` and last model file equal (the file
       byte for byte) to those of the same task run directly in this
       process with a port ``DeviceFlowService``. Printed: the boot,
       submit-to-launch and submit-to-end seconds;
    16b a ``TaskManager(pool=PoolScheduler(ChipPool([two MeshSpecs of half
       the card's memory])))``: the cost oracle's static budget measured
       from one round of ``fedavg_mnist_mlp`` (``measure_hbm_budget``), its
       estimate for the task held at or above the task's measured peak; a
       task whose ``scheduling.peak_hbm_bytes`` is twice the card's memory
       refused at submit (``admission_rejected``, oom, never launched); a
       MIGRATE_ROUNDS-round checkpointed ``fedavg_mnist_mlp`` held after
       MIGRATE_AFTER rounds and migrated to the other worker. Held:
       SUCCEEDED, one resume charged, the preempted and migrated events,
       the final params bitwise its uninterrupted run's. Printed: the fence
       seconds, from the stop to the first resumed round;
    16c FLOW_MESSAGES messages published into a real-time flow (batches of
       FLOW_BATCH, drop probability FLOW_DROP, seed FLOW_SEED) of the port's
       ``DeviceFlowService`` over durable SQLite rooms. Held: the outbound
       collector's batches equal those of the same service over in-memory
       rooms and the kept messages those of a numpy oracle of the flow's
       generator. Printed: messages per second, durable and in-memory.

17. Task inputs from outside (K1 is on this path, in 17a's evaluate):
    every archive written by the script from INGEST_SEED into a temporary
    directory, in its published layout;
    17a a Sent140 zip (``training.1600000.processed.noemoticon.csv``, every
       field quoted, SENT140_ROWS rows cut from 1,600,000, from
       SENT140_USERS users, and a test CSV of SENT140_TEST_ROWS rows, the
       config's eval_n; a sentiment word of its label in every tweet) as the
       ``data_path`` of ``fedadam_sent140_distilbert`` at full width, clients
       10,000 -> 64, block 64 -> DISTILBERT_BLOCK as in 8d, INGEST_ROUNDS
       rounds, ``data.real`` SENT140_REAL; then its witness, the same task
       at a local learning rate of WITNESS_LOCAL_LR for WITNESS_ROUNDS
       rounds (the config's rate diverges within a round at this width);
       held: the population and eval set bitwise ``load_population`` of
       the same zip run again, the witness's eval accuracy at WITNESS_ACC
       or above, its model (q/k/v stacked into the flash layout) evaluated
       on the test split through K1, launched depth x eval batches times,
       its logits within EVAL_LOGITS_ATOL of the dense model's (and its
       loss within EVAL_LOSS_TOL) and, on one batch, of the CPU path, and
       the same check failing K1 with its key mask dropped and with
       uniform weights; printed: fetch and extract, parse and partition
       seconds, rounds/sec and peak memory;
    17b MNIST's four gzipped IDX files at their published sizes (60,000 and
       10,000 rows of 28x28 uint8, seeded class patterns) packed as
       ``mnist.tar.gz`` and served by an ``http.server`` thread on
       127.0.0.1: ``fedavg_mnist_mlp`` uncut but for rounds (INGEST_ROUNDS),
       ``data_transfer_type`` HTTP, Dirichlet 0.5, with an operator EXT_OP
       whose code comes from a local zip (FILE): an ``OperatorABC`` that
       fails for odd client ids; held: the HTTP population bitwise the same
       archive read as a FILE path, the operator's success and failed 50
       and 50 every round, the train rows finite; printed: the HTTP fetch
       seconds and the operator's wall seconds a round (100 subprocesses,
       8 at a time);
    17c the same files as a local zip, ``data_split_type`` true with
       allocation HYBRID_ALLOCATION, submitted to a ``TaskManager`` over
       SQLite with a phone farm recording its jobs; held: each half's rows
       the stratified reckoning (sum over labels of round(n x 0.25) to the
       device), the phone job handed the ``_device.zip`` shard, the task
       SUCCEEDED with the logical half trained on the card, the shard
       removed at the release;
    17d whether ``websocket``, ``boto3`` and ``minio`` import; a task naming
       each (a ``selection_url``; an S3 and a MinIO model block with
       storage settings) builds where the package imports and otherwise
       fails at build with an error naming the package.

18. The convergence gate, multi-process launch and elastic rescale (K2 is
    on this path, in 18b's workers):
    18a the port's convergence gate (``analysis/convergence_gate.py``): its
       five entries (clean, async_staleness, attack_trimmed_mean,
       attack_undefended, drift_trace) run on the card through
       ``run_convergence_task``, each held within the gate's tolerances of
       the envelopes the port blessed on the CPU
       (``analysis/convergence.json``); printed: each entry's accuracies,
       rounds to target and seconds;
    18b ``MultiHostLauncher`` worlds of worker processes
       (``python -m olearning_sim_tpu_torch.clustermgr.worker``):
       ``smoke_round`` at world 1 over NCCL, and ``smoke_ring_sp`` with
       ``flash full`` at world 2 over gloo, two ranks sharing the card:
       DistilBERT at its published widths (768, 12 heads of 64, MLP 3072),
       depth 2, 4 rows of 2048 tokens with padded tails split over the
       ranks; its ring steps run K2 in each worker, each worker counts its
       K2 launches from 0 around the forward and prints them (none fails
       the phase), and the target holds the ring's logits against the
       dense model's (3e-2, atol and rtol) and shows the same check failing
       K2 with its key mask dropped and with uniform weights;
    18c ``ElasticWorldRunner`` over a slice of two ranks' room on the card:
       phase 4's full-width DistilBERT FedAdam task (its model, server
       optimizer state and 16 clients) at world 1, then 2, then 1 over
       gloo, ELASTIC_SEGMENT_ROUNDS rounds a segment
       (``targets.elastic_text_segment``, checkpoint-restart through the
       round checkpointer); held: the worlds, the history's worlds, and the
       final parameters within ELASTIC_REL of a fixed-world run at dp 1 on
       the card; printed: ``overhead_summary()`` (spawn, torch import,
       joining the world, restore, first round and checkpoint seconds per
       segment: the time to rescale; the step's bytes, the modules the
       first round imported). 18b's worlds run beside 18c's segments
       (their processes share the host's cores and the card).

19. The repository checks on the card (K1 is on this path, in 19c):
    19a every dp-1 variant of the analysis grid
       (``analysis/grid.py``: the JAX package's variant names at its tiny
       shapes, mlp2 8-16-3 on 16 clients; plain, deadline, attack,
       defense, maximal, async, async_defense with both server-update
       layouts, the streamed round, and a tiny DistilBERT's flash
       evaluate), each run under its two knob settings inside the
       operation recorder; held: the two operation sequences equal, the
       CUDA kernel launches equal (``torch.profiler``'s host-side launch
       records between two marks, by correlation id), the host syncs
       ``torch.cuda.set_sync_debug_mode("warn")`` reports equal to the CPU
       recorder's count (``analysis/budgets.json``); printed: launches,
       syncs, the round's peak memory, its parameter and state bytes;
    19b two faults planted in cores the phase builds: the deadline read
       through a Python branch (the retrace and the launch count must
       fail) and a ``float()`` of the round's weight sum (the sync count
       and the audit must fail);
    19c the flash evaluate's K1 launches: depth x eval batches a run, and
       its values at that shape (B 8, H 2, L 8, D 8): the evaluate's
       logits on rows with padded tails within EVAL_LOGITS_ATOL of the
       same core's with K1's plain version, and the same check failing K1
       with its key mask dropped and with uniform weights;
    19d ``python -m olearning_sim_tpu_torch.analysis.check_all --skip
       convergence`` on this machine's Python and torch (started in the
       background before phase 8, after the headline's times), which must
       exit 0.

20. The port's examples (``olearning_sim_tpu_torch/examples/``, no kernel of
    the repo is on their path: none uses flash attention), each at the JAX
    example's sizes, seeds and rounds, each holding its own checks:
    20a in this process: ``library_quickstart`` (mlp2 FedAvg, 256 clients,
       10 rounds, the central eval), ``custom_operator`` (a user operator's
       accounting, 16 of 16 a round), ``queue_submit`` (a task through the
       SQLite intake queue) and ``platform_submit`` (a task submitted to a
       session and polled to SUCCEEDED), their lines and seconds printed;
    20b the multi-rank ones, one process a rank sharing the card over gloo,
       started beside phase 10: ``tensor_pipeline_parallel`` (world 8: mp 1
       and 2 rounds within 2e-2, ``sharded_fraction``, dp 2 x pp 4 GPipe),
       ``moe_expert_parallel`` (dp 2 x ep 4, the loss falling),
       ``long_context_training`` (dp 2 x sp 4, ring and dense accuracy
       within 0.02) and ``elastic_rescale`` (2 -> 4 workers, its
       ``overhead_summary()``);
    20c ``python -m olearning_sim_tpu_torch.ops._build`` (the GPU image's
       build step) in a fresh process beside 20a, which must build or find
       exactly the libraries this process loaded in phase 2.

21. f32 attention on the card (run after phase 6, since it reuses phase 5's
    model): 21a phase 5's trained DistilBERT in f32 compute with flash
    attention, built as a task builds it (``model_overrides`` holding
    ``"dtype": "float32"``), evaluates phase 5's 2048 rows, which must
    launch K1's f32 instance 12 times (6 layers x 2 eval batches), held by
    its logits within F32_EVAL_LOGITS_ATOL of the dense f32 model's, with
    K1's two wrong kernels failing the same check; 21b phase 6 in f32
    compute (``dtype="float32"``): two forwards and an SGD step through
    K2's f32 instance, 6 launches per forward, held by logits and
    gradients against the dense-combine ring in f32 (LC_TOL).

Both launch counts are zeroed just before phase 4 and again just before
phase 6; K1's is read just after phase 5, K2's just after phase 6; K1's
is zeroed again just before 17a's flash evaluate and read just after it,
and again just before 19a's flash evaluate and read just after it;
each 18b worker zeroes and reads its own K2 count around its ring forward;
both are zeroed just before 20a and read just after it (0: no example runs
flash attention), and just before 21a's flash evaluate, K1's read just
after it; 21b zeroes and reads them as phase 6 does. The ``kernels`` JSON
has one entry per instance: ``flash_attention`` and ``flash_attention_stats``
(bf16, launches from phases 5 and 6) and their ``_f32`` entries (launches
from 21a and 21b).
The last lines are the
script's seconds, the ``kernels`` JSON, the ``nvidia-smi`` line and ``{"ok": true, "device":
{...}}``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import math
import pathlib
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

STARTED = time.perf_counter()  # the whole script's seconds are printed at its end

# Tolerances of a kernel's o against its plain version: |err| <= ATOL + RTOL*|ref|.
# bf16: the two round p to bf16 at different running maxima and may round
# the output one bf16 ulp (2^-8 relative) apart; f32: summation order only.
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 1e-4)}
# K2's m and l are f32 whatever the input type: the kernel's FMA chain and
# online rescaling against the plain version's matmul, summation order only.
STATS_TOL = (1e-4, 1e-4)
# Loss of one eval batch, flash kernel on the card vs plain version on the CPU.
EVAL_LOSS_TOL = 2e-2
# Phase 17a, logits of a trained DistilBERT (bf16 compute), K1's flash model
# against the dense-attention model and against the plain version on the
# CPU: K1 rounds p to bf16 before P.V where the dense softmax does not,
# through 6 layers (absolute, as LC_LOGITS_ATOL below).
EVAL_LOGITS_ATOL = 5e-2
# Long-context phase, K2's ring model against the dense-combine ring model
# (same parameters, bf16 compute): the kernel rounds p to bf16 before P.V
# where the dense combine keeps it f32, through 6 layers. Logits: absolute;
# gradients: ||g_flash - g_dense|| / ||g_dense|| over all parameters.
LC_LOGITS_ATOL = 5e-2
LC_GRAD_REL = 5e-2
# Phase 21, f32 compute on both sides: the kernels' split-precision TF32
# products (about 2^-22 of each; one TF32 product keeps 2^-11) and summation
# order through 6 layers. K1's flash model against the dense model by
# logits (absolute; the two wrong kernels must still fail it), K2's ring
# against the dense-combine ring by logits and gradients as above.
F32_EVAL_LOGITS_ATOL = 1e-3
LC_TOL = {"bfloat16": (LC_LOGITS_ATOL, LC_GRAD_REL), "float32": (1e-3, 1e-3)}
# Phase 7, a round on the card against the same round on the CPU (same
# parameters, data and indices, bf16 compute with f32 accumulation on both,
# TF32 off): the two differ where cuDNN/cuBLAS and the CPU accumulate in
# another order and a bf16 activation or gradient rounds to the neighbouring
# value (2^-8 relative). Over one round of up to 10 local steps that moves
# each step's update by well under 1%; a wrong padding, layout or update
# rule moves it by O(1). Compared: what the (last) round moved (global
# params, and SCAFFOLD's c_i and c, Ditto's v_k), as ||card - cpu|| / ||cpu||.
CARD_CPU_REL = 5e-2
# Phase 8e/8f/8h/8i/8k: the runner against a direct loop, and a retried or
# resumed run against a clean one: the same card, kernels, seed and
# minibatch draws (seeded from the round counter), so the two must agree to
# float rounding of identical work (relative L2 over all parameters, and
# over each Adam moment in 8i). 8j's warm start must hold the exported
# params exactly, and 8l's resumed convergence record must be identical.
RUNNER_DIRECT_REL = 1e-6
RETRY_REL = 1e-6
# Phase 8d's block of full-width DistilBERT clients (phase 4 uses 8). The
# config's block of 64 runs an 80 GB card out of memory even alone
# (scripts/task_path_memory.py measures each block size).
DISTILBERT_BLOCK = 16
# Phase 10's cuts: 10a's 3,500 clients to 64 "high" + 64 "low"; 10b's
# 10,000 to 256 in the config's 3:4:3 proportion of high/mid/low; 10c's
# synthetic text clients and its eval batch (moe_text's dispatch tensor is
# [S, E, capacity], with capacity a share of S, the batch's tokens).
RESNET_CLIENTS = (64, 64)
VIT_CLIENTS = (38, 52, 38)
MOE_CLIENTS = 64
MOE_EVAL_BATCH = 256
# Phase 10d, a family's round on the card against the CPU's. In f32
# compute (TF32 off) the card's move was measured 2.3e-6 to 6.5e-4
# (relative L2) from the CPU's, while a bf16 move lies 1.25e-2 (moe_text)
# to 6.7e-2 (resnet18) from the f32 one: FAMILY_F32_REL sits between, so
# a card that computed in bf16 where f32 was asked fails. A bf16 round is
# held by how far it moves from the CPU's f32 round against the CPU's own
# bf16 round (resnet18's bf16 gradient on one minibatch is 5-13% from its
# f32 gradient, tests/test_torch_resnet.py): measured 0.99-1.06 times.
# The CPU tests hold the port against JAX by the same ratio and limit
# (sound 0.94-1.12; PERF.md section 6 lists what planted faults read).
FAMILY_F32_REL = 5e-3
BF16_NOISE_RATIO = 1.3
# Phase 9's per-round record fields (deadline rounds, attacks, defense),
# and phase 12's (async rounds; round_close_s and idle_s are among the
# former).
ROBUST_KEYS = ("selected", "on_time", "stragglers", "deadline_s", "round_close_s", "idle_s",
               "attacked", "attack_mode", "clipped", "flagged")
ASYNC_KEYS = ("commits", "committed", "stale_dropped", "windows", "commit_clock")
# Phase 9b: the card's robust aggregate and scores against a float64 numpy
# oracle over the same [C, ...] delta buffer: |card - oracle| <= ORACLE_RTOL
# * |oracle| + ORACLE_ATOL_REL * max |leaf|. The card sorts exactly and
# sums the window in f32; a trimmed mean near zero has no relative accuracy
# to hold, so its absolute term scales with the buffer's largest value. The
# card's aggregates miss by under 1e-9 absolute (PERF.md, phase 9b, gives
# the reading and its headroom); the distance sums run over 159,010 f32
# squares and are held relatively.
ORACLE_RTOL = 1e-5
ORACLE_ATOL_REL = 1e-7
# Phase 9b's attackers (tests/test_defense.py's acceptance test) and their
# attack: each ships -8 times its delta every round.
ATTACKERS = [2, 6, 11, 13]
ATTACK_PLAN = {"seed": 0, "specs": [{"point": "runner.attack_clients", "times": -1,
                                     "payload": {"mode": "scale", "factor": -8.0,
                                                 "clients": ATTACKERS}}]}
ROOT = pathlib.Path(__file__).resolve().parent
# The Pallas kernels that csrc/flash_attention.cu replaces: _attn_kernel and
# _attn_stats_kernel in the JAX package's ops/flash_attention.py (the port's
# code names that package nowhere else).
REPLACES_FLASH = "olearning_sim_" "tpu/ops/flash_attention.py:84"
REPLACES_STATS = "olearning_sim_" "tpu/ops/flash_attention.py:52"
KERNEL_SOURCE = "olearning_sim_tpu_torch/csrc/flash_attention.cu"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
TF32_FLOPS = 495e12              # H100 SXM dense TF32 tensor-core peak


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_all():
    """Phase 2: ``ops._build.build_all`` (the GPU image's build step), then
    each library loaded into this process."""
    from olearning_sim_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    for src in libs:
        _build.load(src)
    log(f"build: {len(libs)} kernel source(s) in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{lib} ({'built' if built else 'found'})"
                    for lib, built in libs.values()))
    for src, text in _build.build_logs.items():
        kernel = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                found = re.search(r"(attn_\w+?_kernel)I(f|13__nv_bfloat16)Li(\d+)ELb(\d)", line)
                kernel = (f" {found[1]}<{'float' if found[2] == 'f' else 'bf16'}, {found[3]}, "
                          f"{found[4]}>" if found else "")
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}{kernel}: {line.strip()}")


def cuda_time_ms(fn, iters=20, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_mask(B, Lk, gen, dev):
    """Per batch row: all real; a random real prefix; none real (fully
    masked rows); the first 64 keys masked then random holes (an all-masked
    first tile followed by real keys)."""
    import torch

    mask = torch.ones((B, Lk), dtype=torch.float32)
    for b in range(B):
        kind = b % 4
        if kind == 1:
            n = int(torch.randint(1, Lk + 1, (1,), generator=gen))
            mask[b, n:] = 0
        elif kind == 2:
            mask[b] = 0
        elif kind == 3:
            mask[b] = (torch.rand(Lk, generator=gen) > 0.3).float()
            mask[b, :min(64, Lk - 1)] = 0
    return mask.to(dev)


def check_kernel(stats, case, dtype, gen, dev):
    """K1 (``stats`` False: o) or K2 (True: o, m, l) against its plain
    version at ``case`` = (B, H, Lq, Lk, D); rows with no real key must come
    out exactly 0. Returns the max |err| of o."""
    import torch

    from olearning_sim_tpu_torch.ops import flash_attention, flash_attention_stats
    from olearning_sim_tpu_torch.ops.flash_attention import (
        flash_attention_reference,
        flash_attention_stats_reference,
    )

    B, H, Lq, Lk, D = case
    q = torch.randn((B, H, Lq, D), generator=gen).to(dev, dtype)
    k = torch.randn((B, H, Lk, D), generator=gen).to(dev, dtype)
    v = torch.randn((B, H, Lk, D), generator=gen).to(dev, dtype)
    mask = make_mask(B, Lk, gen, dev)
    with torch.no_grad():
        if stats:
            outs = flash_attention_stats(q, k, v, kv_mask=mask)
            refs = flash_attention_stats_reference(q, k, v, kv_mask=mask)
        else:
            outs = (flash_attention(q, k, v, kv_mask=mask),)
            refs = (flash_attention_reference(q, k, v, kv_mask=mask),)
    torch.cuda.synchronize()
    tols = [TOL[str(dtype).split(".")[-1]], STATS_TOL, STATS_TOL]
    dead = mask.sum(1) == 0
    name = "flash_attention_stats" if stats else "flash_attention"
    errs, ok, parts = [], True, []
    for what, out, ref, (atol, rtol) in zip("oml", outs, refs, tols):
        out, ref = out.float(), ref.float()
        err = (out - ref).abs()
        max_err = float(err.max())
        bad = int((err > atol + rtol * ref.abs()).sum())
        dead_max = float(out[dead].abs().max()) if bool(dead.any()) else 0.0
        ok = ok and bad == 0 and math.isfinite(max_err) and dead_max == 0.0
        errs.append(max_err)
        parts.append(f"{what}: max_abs_err={max_err:.3e} (atol {atol:g} + rtol {rtol:g}*|ref|, "
                     f"{bad} outside), fully-masked rows max|{what}|={dead_max:g}")
    log(f"kernel {name} {str(dtype):15s} B={B} H={H} Lq={Lq} Lk={Lk} D={D}: "
        + "; ".join(parts) + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at {case} {dtype}")
    return errs[0]


# K1's ragged, multi-tile, Lq != Lk and D 96/128 cases, shared by K2.
RAGGED_CASES = [
    (3, 5, 50, 50, 40),      # ragged Lq, Lk and D
    (2, 4, 512, 512, 64),    # multi-tile Lk
    (2, 3, 70, 200, 128),    # Lq != Lk, widest head dim
    (4, 2, 33, 130, 96),     # ragged D above 64
    (2, 3, 100, 77, 36),     # D not a multiple of 8: the wrapper pads bf16 D to 40
    (2, 4, 300, 1000, 64),   # Lq != Lk over several 128-key tiles, ragged last tile
    (8, 2, 8, 8, 8),         # phase 19c's tiny DistilBERT: D 8 under the 16-wide bf16 k-step
]


def sdpa_backend(q, k, v, mask) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these inputs."""
    import torch
    from torch.nn.attention import SDPBackend

    return SDPBackend(int(torch._fused_sdp_choice(q, k, v, mask, 0.0, False))).name


def attention_bound(B, H, Lq, Lk, D, itemsize, stats_bytes, flops_per_s, products=1):
    """The least time (ms) the card could take for one attention call, and
    what bounds it: the bytes the function must move (q, k, v and the mask
    read once; o, and K2's m and l, written once) over 3.35 TB/s against
    its ``products`` x 4*B*H*Lq*Lk*D operations over ``flops_per_s``.
    In bf16 one product at the bf16 tensor-core peak; f32-accurate work
    on the tensor cores is three TF32 products at the TF32 peak."""
    nbytes = 2 * (B * H * Lq * D + B * H * Lk * D) * itemsize + B * Lk * 4 + stats_bytes
    flops = products * 4 * B * H * Lq * Lk * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


# Per input type: the element size and the bound's products and peak.
BOUND_OF = {"bfloat16": (2, 1, BF16_FLOPS), "float32": (4, 3, TF32_FLOPS)}


def time_kernel(name, slice_shape, kernel, plain, library, library_name, gen, dev):
    """For each input type (bf16, f32) at ``slice_shape`` with every key
    real: kernel, plain and library times (ms), the backend the library
    picks, the bound (``attention_bound``) and the roofline share bound /
    kernel time, and the instance's design. Returns ``{dtype name: times}``."""
    import torch

    from olearning_sim_tpu_torch.ops.flash_attention import plan_launch

    B, H, Lq, Lk, D = slice_shape
    q, k, v = (torch.randn((B, H, L, D), generator=gen).to(dev, torch.bfloat16)
               for L in (Lq, Lk, Lk))
    mask = torch.ones((B, Lk), dtype=torch.float32, device=dev)
    bool_mask = (mask > 0)[:, None, None, :]
    stats_bytes = 2 * B * H * Lq * 4 if name == "flash_attention_stats" else 0
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[-1]
        qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
        iters, warmup = (20, 3) if dtype == torch.bfloat16 else (10, 2)
        with torch.no_grad():
            ms = cuda_time_ms(lambda: kernel(qd, kd, vd, kv_mask=mask), iters, warmup)
            plain_ms = cuda_time_ms(lambda: plain(qd, kd, vd, kv_mask=mask), iters, warmup)
            library_ms = cuda_time_ms(lambda: library(qd, kd, vd, attn_mask=bool_mask), iters,
                                      warmup)
        backend = sdpa_backend(qd, kd, vd, bool_mask)
        itemsize, products, peak = BOUND_OF[dt]
        bound_ms, bound_by, nbytes, flops = attention_bound(B, H, Lq, Lk, D, itemsize,
                                                            stats_bytes, peak, products)
        design = plan_launch(dtype, D, Lk).design
        log(f"time {name} {dt} B={B} H={H} Lq={Lq} Lk={Lk} D={D}: kernel ({design}) "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library ({library_name}, backend {backend}) "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB "
            f"over {HBM_BYTES_PER_S / 1e12:g} TB/s, {flops / 1e9:.2f} GFLOP over "
            f"{peak / 1e12:g} TFLOP/s), roofline share {bound_ms / ms:.4f}")
        out[dt] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms, "library_backend": backend,
                   "roofline_share": bound_ms / ms, "design": design}
    return out


def kernel_entries(name, replaces, errs, times):
    """The ``kernels`` JSON entries of one kernel: one per instance, bf16
    under the kernel's name and f32 under ``<name>_f32``; each gets its
    path's ``launches`` later."""
    return {dt: {"name": name if dt == "bfloat16" else f"{name}_f32", "route": "cuda",
                 "source": KERNEL_SOURCE, "replaces": replaces, "max_abs_err": errs[dt],
                 **times[dt]} for dt in ("bfloat16", "float32")}


def kernel_phase(dev):
    """K1 against its plain version, and its times at the flash evaluate's shape."""
    import torch
    import torch.nn.functional as F

    from olearning_sim_tpu_torch.ops import flash_attention
    from olearning_sim_tpu_torch.ops.flash_attention import flash_attention_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    slice_shape = (1024, 12, 64, 64, 64)  # B, H, Lq, Lk, D of the flash evaluate
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case in [slice_shape] + RAGGED_CASES:
            err = check_kernel(False, case, dtype, gen, dev)
            if case == slice_shape:
                errs[str(dtype).split(".")[-1]] = err
    times = time_kernel("flash_attention", slice_shape, flash_attention,
                        flash_attention_reference, F.scaled_dot_product_attention,
                        "scaled_dot_product_attention", gen, dev)
    return kernel_entries("flash_attention", REPLACES_FLASH, errs, times)


def stats_kernel_phase(dev):
    """K2 against its plain version, the compose check through the ring
    merge, and its times at the long-context path's shape."""
    import torch
    import torch.nn.functional as F

    from olearning_sim_tpu_torch.ops import flash_attention_stats
    from olearning_sim_tpu_torch.ops.flash_attention import flash_attention_stats_reference
    from olearning_sim_tpu_torch.parallel.ring_attention import NEG_INF, combine_flash

    gen = torch.Generator().manual_seed(1)
    slice_shape = (8, 12, 2048, 2048, 64)  # B, H, Lq, Lk, D of the long-context forward
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case in [slice_shape] + RAGGED_CASES:
            err = check_kernel(True, case, dtype, gen, dev)
            if case == slice_shape:
                errs[str(dtype).split(".")[-1]] = err

    # Compose: the kernel's stats over the two K/V halves, folded by the
    # ring merge, against the kernel over the whole (make_mask's rows include
    # an all-masked half and rows with no real key).
    B, H, L, _, D = slice_shape
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((B, H, L, D), generator=gen).to(dev, dtype) for _ in range(3))
        mask = make_mask(B, L, gen, dev) > 0
        with torch.no_grad():
            whole, _, _ = flash_attention_stats(q, k, v, kv_mask=mask)
            qf = q.float()
            m = torch.full_like(qf[..., :1], NEG_INF)
            l = torch.zeros_like(qf[..., :1])
            acc = torch.zeros_like(qf)
            for h in (slice(0, L // 2), slice(L // 2, L)):
                m, l, acc = combine_flash(q, k[:, :, h].contiguous(), v[:, :, h].contiguous(),
                                          mask[:, h], m, l, acc, 1.0 / math.sqrt(D))
            merged = acc / torch.clamp(l, min=1e-20)
        torch.cuda.synchronize()
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        err = (merged - whole.float()).abs()
        bad = int((err > atol + rtol * whole.float().abs()).sum())
        dead = ~mask.any(1)
        dead_max = float(merged[dead].abs().max()) if bool(dead.any()) else 0.0
        ok = bad == 0 and math.isfinite(float(err.max())) and dead_max == 0.0
        log(f"compose flash_attention_stats {str(dtype):15s} two halves of Lk={L} folded by "
            f"combine_flash vs whole: max_abs_err={float(err.max()):.3e} (atol {atol:g} + "
            f"rtol {rtol:g}*|ref|, {bad} outside), fully-masked rows max|o|={dead_max:g} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2's halves do not compose to the whole in {dtype}")

    times = time_kernel("flash_attention_stats", slice_shape, flash_attention_stats,
                        flash_attention_stats_reference, F.scaled_dot_product_attention,
                        "scaled_dot_product_attention: the same o, without m and l",
                        gen, dev)
    return kernel_entries("flash_attention_stats", REPLACES_STATS, errs, times)


# Earlier phases' results on the card, held by phase 13: each entry's
# final params on the host (and phase 4's round seconds, 9b's peak memory).
RESULTS = {}
MAIN_CFG = dict(batch_size=16, max_local_steps=4, block_clients=8)
MAIN_SEQ_LEN = 64
# Phase 5 holds K1 by the logits of phase 4's model trained from its
# initial parameters for FLASH_TRAIN_ROUNDS rounds at WITNESS_LOCAL_LR,
# over eval rows whose tails are padded from PAD_SEED (14b reuses both).
FLASH_TRAIN_ROUNDS = 8
PAD_SEED = 5


def _host(params):
    return {k: v.detach().cpu().clone() for k, v in params.items()}


def distilbert_setup(dev, plan, local_lr=0.01):
    """Phase 4's full-width DistilBERT FedAdam core on ``plan`` (at
    ``local_lr``, the config's 0.01 by default) and its 16 synthetic
    clients (block 8), this rank's shard placed: 18c's elastic task."""
    from olearning_sim_tpu_torch.clustermgr.targets import text_core

    return text_core(plan, dev, local_lr)


def distilbert_rounds(dev, label):
    """Phase 4's two full-width DistilBERT FedAdam rounds (16 synthetic
    clients, block 8) on the plan over the default group, or a world of
    one: returns (core, state, seconds per round)."""
    import torch

    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    plan = make_mesh_plan()
    core, ds = distilbert_setup(dev, plan)
    cfg = core.config
    state = core.init_state(seed=0, device=dev)
    n_params = sum(p.numel() for p in state.params.values())
    log(f"{label}: distilbert {n_params} params, {ds.padded_clients} clients over dp "
        f"{plan.dp}, block {cfg.block_clients}, batch {cfg.batch_size}, steps "
        f"{cfg.max_local_steps}")
    times = []
    for r in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = core.round_step(state, ds)
        loss = float(metrics.mean_loss)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        real = metrics.client_loss[:ds.num_real_clients]
        if not (math.isfinite(loss) and bool(torch.isfinite(real).all())):
            raise AssertionError(f"{label} {r}: non-finite loss {loss} / {real}")
        log(f"{label} {r}: mean_loss={loss:.6f} clients_trained="
            f"{float(metrics.clients_trained):.0f} seconds={times[-1]:.4f}")
    return core, state, times


def padded_eval_set(n, vocab_size=30522):
    """Phase 5's (and 14b's) held-out rows: ``make_central_text_eval_set``'s
    with seeded padded tails (row i keeps its first 8 to 64 tokens), so
    what K1 computes depends on its key mask."""
    import numpy as np

    from olearning_sim_tpu_torch.engine import make_central_text_eval_set

    x, y = make_central_text_eval_set(0, n, MAIN_SEQ_LEN, vocab_size=vocab_size)
    keep = np.random.default_rng(PAD_SEED).integers(8, MAIN_SEQ_LEN + 1, size=n)
    return np.where(np.arange(MAIN_SEQ_LEN)[None, :] < keep[:, None], x, 0).astype(x.dtype), y


def main_path(dev):
    """Phases 4 and 5; returns K1's launches in them."""
    import torch

    from olearning_sim_tpu_torch.engine import FedCoreConfig, build_fedcore, fedadam
    from olearning_sim_tpu_torch.ops import flash_attention, flash_attention_stats
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    cfg = FedCoreConfig(**MAIN_CFG)
    eval_n = 2048
    x_eval, y_eval = padded_eval_set(eval_n)
    card = card_line()

    flash_attention.launches = flash_attention_stats.launches = 0
    core, state, times = distilbert_rounds(dev, "round")
    RESULTS["4"] = {"params": _host(state.params), "seconds": times}
    log(f"main path rounds/sec (round 1, after the first): {1.0 / times[1]:.4f}")
    t0 = time.perf_counter()
    loss, acc = core.evaluate(state.params, x_eval, y_eval)
    log(f"dense evaluate on {eval_n}: loss={loss:.6f} acc={acc:.4f} "
        f"seconds={time.perf_counter() - t0:.4f}")
    if not math.isfinite(loss):
        raise AssertionError("dense evaluate loss is not finite")

    # The model K1 is held by: phase 4's model and population trained from
    # its initial parameters at the witness's local rate (the config's
    # diverges at this width, and a model it trained leaves attention near
    # uniform), so that wrong kernels move its logits.
    wcore, wds = distilbert_setup(dev, make_mesh_plan(), local_lr=WITNESS_LOCAL_LR)
    state = wcore.init_state(seed=0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FLASH_TRAIN_ROUNDS):
        state, _ = wcore.round_step(state, wds)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    dloss, dacc = wcore.evaluate(state.params, x_eval, y_eval)
    dense_logits = eval_logits(wcore, state.params, x_eval)
    log(f"5 trained: {FLASH_TRAIN_ROUNDS} rounds at local lr {WITNESS_LOCAL_LR:g} from the "
        f"initial parameters in {t_train:.2f} s; dense evaluate loss={dloss:.6f} "
        f"acc={dacc:.4f}, logits max|.| {float(dense_logits.abs().max()):.3f} | {card}")

    flash_core = build_fedcore("distilbert", fedadam(0.01, 0.001), cfg,
                               model_overrides={"attention_impl": "flash"}, device=dev)
    trained = dense_to_flash(state.params)
    RESULTS["5"] = {"flash": _host(trained), "dense": _host(state.params)}
    before = flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    floss, facc = flash_core.evaluate(trained, x_eval, y_eval)
    log(f"flash evaluate on {eval_n}: loss={floss:.6f} acc={facc:.4f} "
        f"seconds={time.perf_counter() - t0:.4f} (dense {dloss:.6f} / {dacc:.4f})")
    launches = flash_attention.launches
    batches = -(-eval_n // cfg.eval_batch_size)
    depth = len(flash_core.model.blocks)
    if launches - before != depth * batches:
        raise AssertionError(
            f"flash kernel launched {launches - before} times, expected "
            f"{depth} layers x {batches} eval batches")
    if not (math.isfinite(floss) and abs(floss - dloss) <= EVAL_LOSS_TOL):
        raise AssertionError("flash evaluate loss is not finite or not the dense one's")
    # Compare launches from here on: the count was read.
    hold_k1_by_logits("5", flash_core, trained, x_eval, dense_logits, card)

    # One eval batch, kernel on the card vs plain version on the CPU.
    n_cmp = 64
    gpu_loss, _ = flash_core.evaluate(trained, x_eval[:n_cmp], y_eval[:n_cmp])
    cpu_params = {k: v.cpu() for k, v in trained.items()}
    cpu_loss, _ = flash_core.evaluate(cpu_params, x_eval[:n_cmp], y_eval[:n_cmp])
    diff = abs(gpu_loss - cpu_loss)
    cdiff = float((eval_logits(flash_core, trained, x_eval[:n_cmp]).cpu()
                   - eval_logits(flash_core, cpu_params, x_eval[:n_cmp])).abs().max())
    log(f"flash eval batch of {n_cmp}: card loss {gpu_loss:.6f}, CPU path loss "
        f"{cpu_loss:.6f}, |diff| {diff:.3e} (tol {EVAL_LOSS_TOL:g}); logits max|card - CPU "
        f"path| {cdiff:.3e} (tol {EVAL_LOGITS_ATOL:g})")
    if not (diff <= EVAL_LOSS_TOL and cdiff <= EVAL_LOGITS_ATOL):
        raise AssertionError("flash evaluate on the card disagrees with the CPU path")
    return launches


def long_context_path(dev, dtype="bfloat16", label="long-context"):
    """Phase 6 (bf16 compute) or 21b (``dtype`` "float32", the task path's
    spelling); returns K2's launches in it."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from olearning_sim_tpu_torch.engine.algorithms import SGD
    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.ops import flash_attention, flash_attention_stats

    B, L, lr = 8, 2048, 0.01
    rng = np.random.default_rng(0)
    spec = get_model("distilbert")
    tokens = rng.integers(1, spec.defaults["vocab_size"], size=(B, L))
    for row, n in ((1, 1536), (3, 1000), (5, 257), (7, 1800)):  # padded tails
        tokens[row, n:] = 0
    tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    labels = torch.as_tensor(rng.integers(0, 2, size=B), dtype=torch.long, device=dev)

    logits_atol, grad_rel = LC_TOL[dtype]
    models = {use_flash: spec.build(max_len=L, attention_impl="ring",
                                    ring_use_flash=use_flash, dtype=dtype)
              for use_flash in (True, False)}
    params = models[True].init_params(torch.Generator().manual_seed(0))
    for m in models.values():
        m.load_state_dict(params)
        m.to(dev)
    n_params = sum(p.numel() for p in params.values())
    depth = len(models[True].blocks)
    log(f"{label} path: distilbert {n_params} params, {dtype} compute, ring of one, "
        f"{B} rows x {L} tokens ({int((tok != 0).sum())} real)")

    flash_attention.launches = flash_attention_stats.launches = 0
    forwards = 0
    fwd_s = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = models[True](tok)
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t0)
            forwards += 1
        ref = models[False](tok)
        torch.cuda.synchronize()
    diff = float((logits - ref).abs().max())
    ok = bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (B, 2) \
        and diff <= logits_atol
    log(f"{label} forward (K2 ring): seconds {fwd_s[0]:.4f} (first), {fwd_s[1]:.4f} "
        f"(second); logits vs dense-combine ring max|diff| {diff:.3e} "
        f"(tol {logits_atol:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the K2 ring model's logits disagree with the dense "
                             "combine's")

    def sgd_step(model):
        """One SGD step through the model's ring attention; returns the loss,
        the gradients, the seconds and the peak device memory (GiB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(tok).float(), labels)
        loss.backward()
        grads = {k: p.grad for k, p in model.named_parameters()}
        updates, _ = SGD(lr).update(grads, {})
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.add_(updates[k])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return float(loss.detach()), grads, secs, torch.cuda.max_memory_allocated(dev) / 2**30

    loss_f, g_f, secs_f, peak_f = sgd_step(models[True])
    forwards += 1
    launches = flash_attention_stats.launches
    loss_d, g_d, secs_d, peak_d = sgd_step(models[False])
    num = math.sqrt(sum(float(((g_f[k] - g_d[k]).float() ** 2).sum()) for k in g_d))
    den = math.sqrt(sum(float((g_d[k].float() ** 2).sum()) for k in g_d))
    finite = all(bool(torch.isfinite(g).all()) for g in g_f.values())
    ok = math.isfinite(loss_f) and finite and num / den <= grad_rel
    log(f"{label} SGD step (lr {lr}): K2 ring loss {loss_f:.6f} in {secs_f:.4f} s, "
        f"peak {peak_f:.2f} GiB; dense-combine ring loss {loss_d:.6f} in {secs_d:.4f} s, "
        f"peak {peak_d:.2f} GiB; gradient rel L2 diff {num / den:.3e} "
        f"(tol {grad_rel:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the K2 ring step disagrees with the dense-combine step")
    if launches != depth * forwards:
        raise AssertionError(f"{label}: K2 launched {launches} times, expected {depth} layers "
                             f"x {forwards} forwards")
    log(f"{label} K2 launches: {launches} ({depth} layers x {forwards} forwards)")
    return launches


def f32_path(dev):
    """Phase 21, f32 attention on the card; returns K1's launches in 21a
    and K2's in 21b. 21a: phase 5's trained model in f32 compute with flash
    attention, built as a task builds it (``model_overrides`` with
    ``"dtype": "float32"``), evaluates phase 5's 2048 rows (K1's f32
    instance, depth x eval batches launches), held by its logits against
    the dense f32 model's and by the two wrong kernels failing the same
    check. 21b: phase 6 in f32 compute (K2's f32 instance in the ring)."""
    import torch

    from olearning_sim_tpu_torch.engine import FedCoreConfig, build_fedcore, fedadam
    from olearning_sim_tpu_torch.ops import flash_attention, flash_attention_stats

    t_phase = time.perf_counter()
    card = card_line()
    cfg = FedCoreConfig(**MAIN_CFG)
    eval_n = 2048
    x_eval, y_eval = padded_eval_set(eval_n)
    cores = {impl: build_fedcore("distilbert", fedadam(0.01, 0.001), cfg,
                                 model_overrides={"attention_impl": impl, "dtype": "float32"},
                                 device=dev)
             for impl in ("dense", "flash")}
    params = {impl: {k: v.to(dev) for k, v in RESULTS["5"][impl].items()}
              for impl in ("dense", "flash")}
    if cores["flash"].model.dtype != torch.float32:
        raise AssertionError(f"21a: the model computes in {cores['flash'].model.dtype}")
    dloss, dacc = cores["dense"].evaluate(params["dense"], x_eval, y_eval)
    dense_logits = eval_logits(cores["dense"], params["dense"], x_eval)

    flash_attention.launches = flash_attention_stats.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    floss, facc = cores["flash"].evaluate(params["flash"], x_eval, y_eval)
    secs = time.perf_counter() - t0
    k1 = flash_attention.launches
    batches = -(-eval_n // cfg.eval_batch_size)
    depth = len(cores["flash"].model.blocks)
    log(f"21a f32 flash evaluate on {eval_n}: loss={floss:.6f} acc={facc:.4f} seconds="
        f"{secs:.4f} (dense f32 {dloss:.6f} / {dacc:.4f}); K1 launches {k1} ({depth} layers x "
        f"{batches} eval batches)")
    if k1 != depth * batches or flash_attention_stats.launches != 0:
        raise AssertionError(f"21a: K1 launched {k1} times, expected {depth} layers x "
                             f"{batches} eval batches")
    if not (math.isfinite(floss) and abs(floss - dloss) <= EVAL_LOSS_TOL):
        raise AssertionError("21a: the f32 flash evaluate loss is not finite or not the "
                             "dense one's")
    hold_k1_by_logits("21a", cores["flash"], params["flash"], x_eval, dense_logits, card,
                      atol=F32_EVAL_LOGITS_ATOL)
    del cores, params
    torch.cuda.empty_cache()

    k2 = long_context_path(dev, dtype="float32", label="21b")
    log(f"phase 21 seconds: {time.perf_counter() - t_phase:.1f}")
    return k1, k2


def fl_rounds(label, core, ds, dev, rounds, x_eval, y_eval, num_steps=None):
    """Drive ``rounds`` rounds of ``core`` on the placed population ``ds``
    through the entry points a user calls, check every round, print the
    sub-phase's numbers and return the final state and per-client state."""
    import statistics

    import torch

    alg = core.algorithm
    real = ds.num_real_clients
    steps = num_steps if num_steps is not None else torch.full(
        (ds.num_clients,), core.config.max_local_steps, dtype=torch.int64)
    expect = int(((steps[:real] > 0) & (ds.weight[:real].cpu() > 0)).sum())
    state = core.init_state(seed=0, device=dev)
    aux = {}  # the round's per-client state, passed in and returned
    if alg.control_variates:
        aux = {"control": core.init_control(state, ds.num_clients)}
    if alg.personalized:
        aux = {"personal": core.init_personal(state, ds.num_clients)}
    n_params = sum(p.numel() for p in state.params.values())
    log(f"{label}: {n_params} params, {real} clients (padded to {ds.num_clients}), "
        f"block {core.config.block_clients}, batch {core.config.batch_size}, steps "
        f"{core.config.max_local_steps}, {alg.name}")
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for r in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, *new_aux = core.round_step(state, ds, num_steps=num_steps, **aux)
        aux = dict(zip(aux, new_aux))
        loss = float(metrics.mean_loss)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        trained = float(metrics.clients_trained)
        client_loss = metrics.client_loss[:real][steps[:real].to(dev) > 0]
        if not (math.isfinite(loss) and bool(torch.isfinite(client_loss).all())):
            raise AssertionError(f"{label} round {r}: non-finite loss {loss}")
        if trained != expect:
            raise AssertionError(f"{label} round {r}: {trained} clients trained, "
                                 f"expected {expect}")
        extra = (f" personal_loss={float(metrics.personal_loss):.6f}"
                 if alg.personalized else "")
        log(f"{label} round {r}: mean_loss={loss:.6f}{extra} clients_trained="
            f"{trained:.0f} seconds={times[-1]:.4f}")
    rps = 1.0 / statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    eval_loss, eval_acc = core.evaluate(state.params, x_eval, y_eval)
    if not math.isfinite(eval_loss):
        raise AssertionError(f"{label}: evaluate loss is not finite")
    line = (f"{label}: rounds/sec after the first {rps:.4f}, device-rounds/sec "
            f"{real * rps:.1f}, peak device memory {peak:.3f} GiB, evaluate on "
            f"{len(y_eval)} rows loss={eval_loss:.6f} acc={eval_acc:.4f}")
    if alg.personalized:
        p_loss, p_acc = core.evaluate_personal(aux["personal"], ds)
        if not math.isfinite(p_loss):
            raise AssertionError(f"{label}: evaluate_personal loss is not finite")
        line += f", evaluate_personal loss={p_loss:.6f} acc={p_acc:.4f}"
    log(line + f" | {card_line()}")
    return state, aux


def _moved_on(where, family, alg, cfg, shape, host, draws, num_steps, rounds,
              overrides=None):
    """``rounds`` rounds of ``family`` on ``where`` from seed 0's params on the
    host population ``host`` with the given minibatch ``draws``: what the
    last round moved (global params, and SCAFFOLD's c_i and c, Ditto's
    v_k) on the CPU in f32, the last round's mean loss, and its max |c -
    c_i|. ``draws`` is filled from the core's own draw when empty."""
    import torch

    from olearning_sim_tpu_torch.engine import build_fedcore

    core = build_fedcore(family, alg, cfg, model_overrides=overrides, input_shape=shape,
                         device=where)
    ds = host.to(where)
    state = core.init_state(seed=0, device=where)
    if not draws:
        gen = torch.Generator().manual_seed(7)
        draws += [(core.draw_indices(gen, ds.num_samples),
                   core.draw_indices(gen, ds.num_samples) if alg.personalized else None)
                  for _ in range(rounds)]
    aux = {}
    if alg.control_variates:
        aux["control"] = core.init_control(state, ds.num_clients)
    if alg.personalized:
        aux["personal"] = core.init_personal(state, ds.num_clients)
    for idx, pidx in draws:
        kw = {"indices": idx, "num_steps": num_steps}
        if alg.personalized:
            kw["personal_indices"] = pidx
            v0 = {k: v.clone() for k, v in aux["personal"].params.items()}
        correction = (max(float((c - ci).abs().max()) for c, ci in zip(
            aux["control"].server_control.values(),
            aux["control"].client_controls.values()))
            if alg.control_variates else 0.0)
        before = {k: v.clone() for k, v in state.params.items()}
        out = core.round_step(state, ds, **kw, **aux)
        state, aux = out[0], dict(zip(aux, out[2:]))
    moved = {f"params.{k}": out[0].params[k] - before[k] for k in before}
    if alg.control_variates:
        moved.update({f"c_i.{k}": v for k, v in out[2].client_controls.items()})
        moved.update({f"c.{k}": v for k, v in out[2].server_control.items()})
    if alg.personalized:
        moved.update({f"v_k.{k}": v.float() - v0[k].float()
                      for k, v in out[2].params.items()})
    return ({k: v.float().cpu() for k, v in moved.items()}, float(out[1].mean_loss),
            correction)


def _group_gaps(a, b):
    """Per group of ``_moved_on``'s keys (params, c_i, c, v_k): (group,
    ||a - b|| / ||b||, max |a - b|)."""
    out = []
    for group in sorted({k.split(".")[0] for k in b}):
        keys = [k for k in b if k.split(".")[0] == group]
        num = math.sqrt(sum(float(((a[k] - b[k]) ** 2).sum()) for k in keys))
        den = math.sqrt(sum(float((b[k] ** 2).sum()) for k in keys))
        max_abs = max(float((a[k] - b[k]).abs().max()) for k in keys)
        out.append((group, num / den if den > 0 else float("inf"), max_abs))
    return out


def card_vs_cpu(dev, label, family, alg, cfg, shape, n_local, alpha, num_steps=None,
                rounds=1):
    """``rounds`` rounds of 8 clients on the card and on the CPU from the
    same parameters, data and minibatch indices; what the last round moved
    (and the controls it left) must agree within CARD_CPU_REL (relative
    L2). SCAFFOLD takes two rounds: in the first c = c_i = 0, so only the
    second applies the correction g + c - c_i."""
    import torch

    from olearning_sim_tpu_torch.engine import make_synthetic_dataset

    host = make_synthetic_dataset(0, 8, n_local, shape, 10, dirichlet_alpha=alpha)
    draws = []
    (card, card_loss, corr), (cpu, cpu_loss, _) = (
        _moved_on(where, family, alg, cfg, shape, host, draws, num_steps, rounds)
        for where in (dev, torch.device("cpu")))
    if alg.control_variates and rounds > 1 and not corr > 0:
        raise AssertionError(f"{label}: the compared round ran with c = c_i")
    gaps = _group_gaps(card, cpu)
    ok = all(rel <= CARD_CPU_REL for _, rel, _ in gaps)
    extra = f", last round's max |c - c_i| {corr:.3e}" if alg.control_variates else ""
    log(f"card vs CPU, {label} ({rounds} round(s){extra}): mean_loss card {card_loss:.6f} "
        f"CPU {cpu_loss:.6f}; " + "; ".join(
            f"{group} rel L2 {rel:.3e} (max |diff| {max_abs:.3e})"
            for group, rel, max_abs in gaps)
        + f" (tol {CARD_CPU_REL:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the round on the card disagrees with the CPU's")


def headline_path(dev):
    """Phase 7: the headline families and the other algorithms."""
    import numpy as np
    import torch

    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        ditto,
        fedavg,
        fedprox,
        make_central_eval_set,
        make_synthetic_dataset,
        scaffold,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    mlp_shape, cnn_shape = (784,), (32, 32, 3)
    mlp_cfg = FedCoreConfig(batch_size=32, max_local_steps=10, block_clients=32)
    cnn_cfg = FedCoreConfig(batch_size=32, max_local_steps=10, block_clients=128)
    t0 = time.perf_counter()
    mlp_ds = make_synthetic_dataset(0, 100, 64, mlp_shape, 10, class_sep=2.0)
    mlp_ds = mlp_ds.pad_for(mlp_cfg.block_clients).to(dev)
    cnn_ds = make_synthetic_dataset(0, 1000, 50, cnn_shape, 10, dirichlet_alpha=0.5)
    cnn_ds = cnn_ds.pad_for(cnn_cfg.block_clients).to(dev)
    mlp_eval = make_central_eval_set(0, 1024, mlp_shape, 10, class_sep=2.0)
    cnn_eval = make_central_eval_set(0, 2048, cnn_shape, 10)
    log(f"phase 7 data: mlp2 {tuple(mlp_ds.x.shape)}, cnn4 {tuple(cnn_ds.x.shape)} "
        f"{cnn_ds.x.dtype}, made and placed in {time.perf_counter() - t0:.1f} s")

    def core(family, alg, cfg):
        shape = mlp_shape if family == "mlp2" else cnn_shape
        return build_fedcore(family, alg, cfg, input_shape=shape, device=dev)

    fl_rounds("7a fedavg_mnist_mlp", core("mlp2", fedavg(0.05), mlp_cfg), mlp_ds, dev, 3,
              *mlp_eval)
    fl_rounds("7b fedavg_cifar10_cnn", core("cnn4", fedavg(0.05), cnn_cfg), cnn_ds, dev, 3,
              *cnn_eval)
    _, aux = fl_rounds("7c scaffold_mnist_mlp", core("mlp2", scaffold(0.05), mlp_cfg),
                       mlp_ds, dev, 2, *mlp_eval)
    c = aux["control"].server_control
    c_abs = max(float(v.abs().max()) for v in c.values())
    if not (all(bool(torch.isfinite(v).all()) for v in c.values()) and c_abs > 0):
        raise AssertionError(f"7c: server control not finite and non-zero (max |c| {c_abs})")
    log(f"7c server control: finite, max |c| {c_abs:.4e}")
    fl_rounds("7d fedprox cnn4", core("cnn4", fedprox(0.03, mu=0.1), cnn_cfg), cnn_ds, dev, 2,
              *cnn_eval)
    ditto_cfg = FedCoreConfig(batch_size=32, max_local_steps=8, block_clients=32,
                              personal_dtype=torch.bfloat16)
    profile_steps = np.zeros(mlp_ds.num_clients, np.int64)  # padding: no step
    for steps, third in zip((8, 5, 2), np.array_split(np.arange(mlp_ds.num_real_clients), 3)):
        profile_steps[third] = steps  # compute profiles high / mid / low
    fl_rounds("7e ditto mlp2", core("mlp2", ditto(0.03, lam=0.1), ditto_cfg), mlp_ds, dev, 2,
              *mlp_eval, num_steps=torch.from_numpy(profile_steps))
    carry_cfg = dataclasses.replace(mlp_cfg, carry_dtype=torch.bfloat16)
    fl_rounds("7f fedavg_mnist_mlp_bf16", core("mlp2", fedavg(0.05), carry_cfg), mlp_ds, dev,
              2, *mlp_eval)
    del mlp_ds, cnn_ds

    small = dict(batch_size=32, max_local_steps=10, block_clients=8)
    card_vs_cpu(dev, "cnn4 FedAvg", "cnn4", fedavg(0.05), FedCoreConfig(**small),
                cnn_shape, 50, 0.5)
    card_vs_cpu(dev, "mlp2 SCAFFOLD", "mlp2", scaffold(0.05), FedCoreConfig(**small),
                mlp_shape, 64, None, rounds=2)
    card_vs_cpu(dev, "mlp2 Ditto", "mlp2", ditto(0.03, lam=0.1),
                FedCoreConfig(**dict(small, max_local_steps=8),
                              personal_dtype=torch.bfloat16),
                mlp_shape, 64, None, num_steps=torch.tensor([8, 8, 8, 5, 5, 5, 2, 2]))
    log(f"phase 7 seconds: {time.perf_counter() - t_phase:.1f}")


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _engine_params(task):
    return json.loads(task["operatorflow"]["operators"][0]["logical_simulation"]
                      ["operator_params"])


def _set_engine_params(task, params):
    task["operatorflow"]["operators"][0]["logical_simulation"]["operator_params"] = \
        json.dumps(params)


def block_edit(block):
    """An ``edit`` for :func:`run_task` that sets the task's block of clients."""
    def edit(task):
        params = _engine_params(task)
        old = params["fedcore"]["block_clients"]
        params["fedcore"]["block_clients"] = block
        _set_engine_params(task, params)
        return f"block_clients {old} -> {block}"
    return edit


def _rel_l2(a, b):
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return math.sqrt(num / den)


def load_task(name, rounds, clients=None, edit=None, shrink=None):
    """A task JSON from ``configs/`` cut as :func:`run_task` describes, and
    the list of its cuts."""
    task = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    fs = task["operatorflow"]["flow_setting"]
    cuts = [f"rounds {fs['round']} -> {rounds}"]
    fs["round"] = rounds
    for td in task["target"]["data"]:
        if clients is not None:
            ts = td["total_simulation"]
            old, dyn = ts["nums"], ts["dynamic_nums"]
            ts["dynamic_nums"] = [d * n // o for d, n, o in zip(dyn, clients, old)]
            ts["nums"] = td["allocation"]["logical_simulation"] = list(clients)
            cuts.append(f"clients {old} -> {list(clients)} (dynamic_nums {dyn} -> "
                        f"{ts['dynamic_nums']})")
    if edit is not None:
        cuts.append(edit(task))
    if shrink is not None:
        shrink(task)
    return task, cuts


def run_task(label, name, dev, rounds, clients=None, edit=None, chaos=None, shrink=None,
             stop_after=None, peaks=None):
    """One task JSON from ``configs/`` through the port's bridge and runner.
    ``rounds`` / ``clients`` (one count per device class, the failure
    allowance ``dynamic_nums`` scaled with it) cut the loaded JSON; ``edit(task)`` changes it
    further and returns a description of the change; ``chaos`` is a fault
    plan armed in the port's injector for the run; ``stop_after`` sets the
    runner's stop event after that many rounds of this run (a cooperative
    stop, which fences a checkpoint); ``shrink(task)`` is for rehearsals on
    the CPU only. A runner that resumes (a checkpoint or model files) runs
    the rounds left. ``peaks``, a list, receives each step's peak device
    memory (None on the CPU). Prints the sub-phase's numbers and returns
    (runner, history)."""
    import statistics
    import threading
    from contextlib import nullcontext

    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from olearning_sim_tpu_torch.resilience import faults
    from olearning_sim_tpu_torch.telemetry import MetricsRegistry, default_tracer

    task, cuts = load_task(name, rounds, clients, edit, shrink)
    if chaos is not None:
        cuts.append(f"fault plan {json.dumps(chaos['specs'])}")
    log(f"{label} {name}: " + "; ".join(cuts))
    registry = MetricsRegistry()
    tracer = default_tracer()
    tracer.clear()
    if dev.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    stop = threading.Event() if stop_after is not None else None
    runner = build_runner_from_taskconfig(task, registry=registry, stop_event=stop, device=dev)
    pop = runner.populations[0]
    log(f"{label}: built in {time.perf_counter() - t0:.1f} s: {runner.core.algorithm.name}, "
        f"{pop.dataset.num_real_clients} clients (padded to {pop.dataset.padded_clients}), "
        f"features {tuple(pop.dataset.x.shape)} {pop.dataset.x.dtype}, "
        f"{len(runner.operators)} operator(s)")
    times = []
    with faults.chaos(faults.FaultPlan.from_dict(chaos)) if chaos else nullcontext():
        t0 = time.perf_counter()
        runner.begin()
        start, restored = runner._loop["round_idx"], len(runner.history)
        if start:
            log(f"{label}: resumed at round {start} in {time.perf_counter() - t0:.4f} s "
                f"({restored} rounds of history restored)")
        more = True
        while more:
            if stop_after is not None and len(times) == stop_after:
                stop.set()
            _sync(dev)
            if peaks is not None and dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            more = runner.step()
            _sync(dev)
            times.append(time.perf_counter() - t0)
            if peaks is not None:
                peaks.append(torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None)
        if stop_after is not None:
            times.pop()  # the step that saw the stop ran no round
        t0 = time.perf_counter()
        history = runner.finish()
        if runner.checkpointer is not None:
            log(f"{label}: finish() waited {time.perf_counter() - t0:.4f} s for the last "
                f"checkpoint commit")
    expected = rounds - start if stop_after is None else stop_after
    if len(history) - restored != expected:
        raise AssertionError(f"{label}: {len(history) - restored} rounds run, expected "
                             f"{expected}")
    n_params = sum(v.numel() for v in runner.states["data_0"].params.values())
    peak = (f", peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB"
            if dev.type == "cuda" else "")
    log(f"{label}: {n_params} params{peak}")
    # Seconds per round of this run (none where a retry replayed a round).
    secs = ([None] * restored + times if len(times) == len(history) - restored
            else [None] * len(history))
    for h, sec in zip(history, secs):
        if h.get("skipped"):
            log(f"{label} round {h['round']}: skipped ({h['error']})")
            continue
        tr = h["train"]["data_0"]
        ev = h.get("evaluate", {}).get("data_0", {})
        if not math.isfinite(tr["mean_loss"]) or tr["clients_trained"] <= 0:
            raise AssertionError(f"{label} round {h['round']}: {tr}")
        if ev and not math.isfinite(ev["eval_loss"]):
            raise AssertionError(f"{label} round {h['round']}: eval loss {ev['eval_loss']}")
        line = (f"{label} round {h['round']}: released={tr['released']} dropped={tr['dropped']} "
                f"clients_trained={tr['clients_trained']} mean_loss={tr['mean_loss']:.6f}")
        # Deadline rounds, attacks and the defense (phase 9).
        line += "".join(f" {k}={tr[k]}" for k in ROBUST_KEYS + ASYNC_KEYS if k in tr)
        if ev:
            line += f" eval_loss={ev['eval_loss']:.6f} eval_acc={ev['eval_acc']:.4f}"
        log(line + ("" if sec is None else f" seconds={sec:.4f}"))
    if len(times) == rounds and rounds > 1:
        # A full run from round 0 (the first round is the warm-up).
        rps = 1.0 / statistics.median(times[1:])
        log(f"{label}: rounds/sec after the first {rps:.4f} (device-rounds/sec "
            f"{pop.dataset.num_real_clients * rps:.1f}), first round {times[0]:.4f} s "
            f"| {card_line() if dev.type == 'cuda' else 'cpu'}")
    # Per phase: count and mean from the runner's series; the median from
    # the spans the same timer records (a histogram keeps only buckets).
    series = registry.get("ols_engine_round_phase_duration_seconds")
    spans = {}
    for sp in tracer.spans():
        if sp.attrs.get("round_idx", 0) >= (1 if rounds > 1 else 0) and sp.name.count(".") == 2:
            spans.setdefault(sp.name[len("round."):], []).append(sp.duration_s)
    parts = []
    for (task_id, op, phase), child in series.children():
        med = statistics.median(spans.get(f"{op}.{phase}", [float("nan")]))
        parts.append(f"{op}.{phase} n={child.count} mean={child.sum / child.count * 1e3:.3f} "
                     f"median(steady)={med * 1e3:.3f}")
    log(f"{label} phase ms: " + "; ".join(parts))
    if runner.checkpointer is not None:
        checkpoint_line(label, registry, runner)
    log(f"{label} logical_result: "
        f"{runner.task_repo.get_item_value(runner.task_id, 'logical_result')}")
    return runner, history


def checkpoint_line(label, registry, runner):
    """A run's checkpoint numbers: per-step save (dispatch) and restore
    seconds and bytes from the runner's ``ols_checkpoint_*`` series, and the
    committed steps' sizes on disk."""
    import os

    parts = []
    for op in ("save", "restore"):
        dur = registry.get(f"ols_checkpoint_{op}_duration_seconds")
        nbytes = registry.get(f"ols_checkpoint_{op}_bytes_total")
        for key, child in (dur.children() if dur is not None else []):
            total = nbytes.labels(task_id=key[0]).value if nbytes is not None else 0
            parts.append(f"{op} n={child.count} seconds/step={child.sum / child.count:.4f} "
                         f"bytes={int(total)}")
    d = runner.checkpointer.directory
    sizes = {s: sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(os.path.join(d, s))
                    for f in fs)
             for s in sorted(os.listdir(d), key=lambda n: (len(n), n)) if s.isdigit()}
    log(f"{label} checkpoint: " + "; ".join(parts) + f"; steps on disk {sizes} bytes")


def direct_loop(dev, name, rounds, shrink=None):
    """Phase 8e: a config's rounds driven directly through the library
    entry points, from the seed and with the participation masks the runner
    uses; returns the final params."""
    import statistics
    import zlib

    import numpy as np
    import torch

    from olearning_sim_tpu_torch.deviceflow import compile_trace
    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        from_config,
        make_synthetic_dataset,
    )

    task = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    if shrink is not None:
        shrink(task)
    params = _engine_params(task)
    model, alg, syn = params["model"], dict(params["algorithm"]), params["data"]["synthetic"]
    cfg = FedCoreConfig.from_dict(params["fedcore"])
    shape = tuple(model["input_shape"])
    core = build_fedcore(model["name"], from_config(alg.pop("name"), **alg), cfg,
                         model_overrides=model["overrides"], input_shape=shape, device=dev)
    n = task["target"]["data"][0]["allocation"]["logical_simulation"][0]
    ds = make_synthetic_dataset(syn["seed"], n, syn["n_local"], shape, syn["num_classes"],
                                class_sep=syn["class_sep"]).pad_for(cfg.block_clients).to(dev)
    task_id = task["task_id"]
    state = core.init_state(seed=zlib.crc32(task_id.encode()) & 0x7FFFFFFF, device=dev)
    times = []
    for r in range(rounds):
        trace = compile_trace(None, n, r, task_id=task_id, operator="train", seed=0)
        mask = np.zeros(ds.num_clients, np.float32)
        mask[:n] = trace.participate
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = core.round_step(state, ds, participate=torch.from_numpy(mask).to(dev))
        loss = float(metrics.mean_loss)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        log(f"8e direct round {r}: mean_loss={loss:.6f} clients_trained="
            f"{float(metrics.clients_trained):.0f} seconds={times[-1]:.4f}")
    log(f"8e direct loop: rounds/sec after the first {1.0 / statistics.median(times[1:]):.4f}")
    return state.params


def _edits(*edits):
    """One ``edit`` for :func:`run_task` made of several."""
    def edit(task):
        return "; ".join(e(task) for e in edits if e is not None)
    return edit


def params_edit(**blocks):
    """An ``edit`` that sets engine-params blocks."""
    def edit(task):
        params = _engine_params(task)
        params.update(blocks)
        _set_engine_params(task, params)
        return "; ".join(f"{k} {json.dumps(v)}" for k, v in blocks.items())
    return edit


def model_edit(root, **model):
    """An ``edit`` that sets the train operator's model block (FILE transfer,
    under ``root``)."""
    def edit(task):
        task["operatorflow"]["operators"][0]["model"].update(model_transfer_type="FILE", **model)
        params = _engine_params(task)
        params["storage"] = {"root": root}
        _set_engine_params(task, params)
        return f"model {json.dumps(model)} under {root}"
    return edit


def _restores(runner):
    """Checkpoint steps this run restored (the runner's restore series)."""
    series = runner.registry.get("ols_checkpoint_restore_duration_seconds")
    return 0 if series is None else series.labels(task_id=runner.task_id).count


def _moments_rel(a, b):
    """Relative L2 of each FedAdam moment (mu, nu) of two server states."""
    return {m: _rel_l2(a.opt_state[m], b.opt_state[m]) for m in ("mu", "nu")}


def resume_path(dev, tmp, runner_a, runner_d, shrink=None):
    """Phases 8h-8l: checkpoint, resume and model files, and convergence
    tracking, through the bridge and runner; files under ``tmp``."""
    import importlib.util
    import os

    from olearning_sim_tpu_torch.engine.convergence import strip_wall
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from olearning_sim_tpu_torch.resilience import CHECKPOINT_FALLBACK, ROLLBACK, global_log

    log(f"msgpack importable here: {importlib.util.find_spec('msgpack') is not None} "
        f"(for the record: the port writes flax's wire format itself)")
    clean = runner_a.states["data_0"].params
    task_id = runner_a.task_id

    def ckpt(sub, **extra):
        return params_edit(checkpoint={"directory": os.path.join(tmp, sub, "{task_id}"),
                                       "every": 1}, **extra)

    def held(label, what, rel, tol):
        log(f"{label}: {what} rel L2 {rel:.3e} (tol {tol:g})")
        if not rel <= tol:
            raise AssertionError(f"{label}: {what} disagree")

    # 8h: 8a stopped after round 0 and resumed by a fresh runner; then a
    # preemption after round 2 trained, recovered from round 1's step; then
    # round 1's step torn and a preemption at round 2: one fallback to
    # round 0's step, and rounds 1-2 replayed.
    run_task("8h stop", "fedavg_mnist_mlp", dev, 3, edit=ckpt("8h"), shrink=shrink,
             stop_after=1)
    runner_h, _ = run_task("8h resume", "fedavg_mnist_mlp", dev, 3, edit=ckpt("8h"),
                           shrink=shrink)
    if _restores(runner_h) != 1:
        raise AssertionError("8h: the fresh runner did not resume from the checkpoint")
    held("8h resume", "final params vs 8a",
         _rel_l2(runner_h.states["data_0"].params, clean), RETRY_REL)
    retry = {"failure_policy": "retry"}
    for sub, specs in (
            ("8h_preempt", [{"point": "runner.pre_checkpoint", "rounds": [2],
                             "error": "preempt"}]),
            ("8h_corrupt", [{"point": "checkpoint.corrupt", "rounds": [1], "error": "corrupt"},
                            {"point": "runner.pre_checkpoint", "rounds": [2],
                             "error": "preempt"}])):
        rb, fb = global_log().count(ROLLBACK, task_id), global_log().count(
            CHECKPOINT_FALLBACK, task_id)
        runner, _ = run_task(f"8h {sub[3:]}", "fedavg_mnist_mlp", dev, 3, shrink=shrink,
                             edit=ckpt(sub, resilience=retry),
                             chaos={"seed": 0, "specs": specs})
        rb = global_log().count(ROLLBACK, task_id) - rb
        fb = global_log().count(CHECKPOINT_FALLBACK, task_id) - fb
        log(f"8h {sub[3:]}: {rb} rollback(s), {fb} checkpoint fallback(s), "
            f"{_restores(runner)} restore(s)")
        if rb != 1 or fb != len(specs) - 1 or _restores(runner) != 1:
            raise AssertionError(f"8h {sub[3:]}: not recovered through the checkpoint")
        held(f"8h {sub[3:]}", "final params vs 8a",
             _rel_l2(runner.states["data_0"].params, clean), RETRY_REL)

    # 8i: 8d at full width, stopped after round 0 and resumed: params and
    # both Adam moments against 8d's uninterrupted run.
    block = block_edit(DISTILBERT_BLOCK) if shrink is None else None
    dist = dict(clients=[64] if shrink is None else None, shrink=shrink,
                edit=_edits(block, ckpt("8i")))
    stopped, _ = run_task("8i stop", "fedadam_sent140_distilbert", dev, 2, stop_after=1, **dist)
    del stopped
    runner_i, _ = run_task("8i resume", "fedadam_sent140_distilbert", dev, 2, **dist)
    got, want = runner_i.states["data_0"], runner_d.states["data_0"]
    if _restores(runner_i) != 1 or got.opt_state["count"] != want.opt_state["count"]:
        raise AssertionError("8i: the fresh runner did not resume from the checkpoint")
    held("8i resume", "final params vs 8d", _rel_l2(got.params, want.params),
         RETRY_REL)
    for m, rel in _moments_rel(got, want).items():
        held("8i resume", f"Adam {m} vs 8d", rel, RETRY_REL)
    del runner_i, got

    # 8j: 8d with modelUpdateStyle: a model file per round; a fresh runner
    # warm-started from the round-1 file holds exactly those params.
    jdir = os.path.join(tmp, "8j")
    style = "{task_id}_{round}_result_model.msgpack"
    runner_j, _ = run_task("8j export", "fedadam_sent140_distilbert", dev, 2,
                           clients=dist["clients"], shrink=shrink,
                           edit=_edits(block, model_edit(jdir, model_update_style=style)))
    for r in range(2):
        path = os.path.join(jdir, style.format(task_id=runner_j.task_id, round=r))
        log(f"8j round {r} model file: {os.path.getsize(path)} bytes")
    task, _ = load_task("fedadam_sent140_distilbert", 2, dist["clients"], _edits(
        block, model_edit(jdir, use_model=True,
                          model_path=style.format(task_id=runner_j.task_id, round=1))), shrink)
    task["task_id"] += "_warm"
    warm = build_runner_from_taskconfig(task, device=dev)
    t0 = time.perf_counter()
    warm.begin()
    log(f"8j warm start from the round-1 file: {time.perf_counter() - t0:.4f} s")
    want = runner_j.states["data_0"].params
    diff = max(float((warm.states["data_0"].params[k] - v).abs().max()) for k, v in want.items())
    log(f"8j warm-started params vs the exporting run's: max abs diff {diff:g} (tol 0)")
    if diff != 0:
        raise AssertionError("8j: the warm-started params are not the exported ones")
    del warm, runner_j

    # 8k: 8a exporting each round; the round-2 file deleted, a fresh runner
    # resumes from the round-1 file and runs round 2.
    kdir = os.path.join(tmp, "8k")
    run_task("8k export", "fedavg_mnist_mlp", dev, 3, shrink=shrink,
             edit=model_edit(kdir, model_update_style=style))
    os.remove(os.path.join(kdir, style.format(task_id=task_id, round=2)))
    runner_k, hist_k = run_task("8k resume", "fedavg_mnist_mlp", dev, 3, shrink=shrink,
                                edit=model_edit(kdir, model_update_style=style))
    if [h["round"] for h in hist_k] != [2]:
        raise AssertionError("8k: the fresh runner did not resume from the round-1 file")
    held("8k resume", "final params vs 8a",
         _rel_l2(runner_k.states["data_0"].params, clean), RETRY_REL)

    # 8l: fedavg_mnist_mlp_convergence cut to 10 rounds; then stopped after
    # round 5 and resumed by a fresh runner: the same record under
    # strip_wall.
    runner_l, _ = run_task("8l", "fedavg_mnist_mlp_convergence", dev, 10, shrink=shrink)
    record = runner_l.convergence_record()
    log(f"8l convergence record: {json.dumps(record)}")
    if [e["round"] for e in record["evals"]] != [4, 9]:
        raise AssertionError("8l: eval points are not at rounds 4 and 9")
    run_task("8l stop", "fedavg_mnist_mlp_convergence", dev, 10, edit=ckpt("8l"),
             shrink=shrink, stop_after=6)
    resumed, _ = run_task("8l resume", "fedavg_mnist_mlp_convergence", dev, 10,
                          edit=ckpt("8l"), shrink=shrink)
    same = strip_wall(resumed.convergence_record()) == strip_wall(record)
    log(f"8l resumed record equals the uninterrupted one under strip_wall: {same} "
        f"(tol: identical)")
    if _restores(resumed) != 1 or not same:
        raise AssertionError("8l: the resumed run's convergence record differs")


def task_path(dev, shrink=None):
    """Phase 8: task JSONs through the port's task bridge and runner."""
    import tempfile

    import torch

    from olearning_sim_tpu_torch.resilience import ROLLBACK, global_log

    t_phase = time.perf_counter()
    runner_a, hist_a = run_task("8a", "fedavg_mnist_mlp", dev, 3, shrink=shrink)
    RESULTS["8a"] = {"params": _host(runner_a.states["data_0"].params)}
    run_task("8b", "fedavg_cifar10_cnn", dev, 2, shrink=shrink)
    run_task("8c", "scaffold_mnist_mlp", dev, 2, shrink=shrink)
    runner_d, hist_d = run_task("8d", "fedadam_sent140_distilbert", dev, 2,
                                clients=[64] if shrink is None else None,
                                edit=block_edit(DISTILBERT_BLOCK) if shrink is None else None,
                                shrink=shrink)
    if not any(h["train"]["data_0"]["dropped"] > 0 for h in hist_d):
        raise AssertionError("8d: the flow_dispatch strategy dropped no client")
    clean = runner_a.states["data_0"].params

    direct = direct_loop(dev, "fedavg_mnist_mlp", 3, shrink=shrink)
    rel = _rel_l2(clean, direct)
    log(f"8e runner vs direct loop: final params rel L2 {rel:.3e} (tol {RUNNER_DIRECT_REL:g})")
    if not rel <= RUNNER_DIRECT_REL:
        raise AssertionError("8e: the runner's rounds disagree with the direct loop's")

    def resilience(obj):
        def edit(task):
            params = _engine_params(task)
            params["resilience"] = obj
            _set_engine_params(task, params)
            return f"resilience {json.dumps(obj)}"
        return edit

    # A fault at round_begin fails round 1 before it trains; one at
    # pre_checkpoint after it has trained, so the failed attempt has moved
    # the params and the round counter, and only a snapshot that restored
    # both replays it.
    task_id = runner_a.task_id
    for point, error in (("runner.round_begin", None), ("runner.pre_checkpoint", "preempt")):
        spec = {"point": point, "rounds": [1]}
        if error is not None:
            spec["error"] = error
        before = global_log().count(ROLLBACK, task_id)
        runner_f, _ = run_task("8f", "fedavg_mnist_mlp", dev, 3, shrink=shrink,
                               edit=resilience({"failure_policy": "retry"}),
                               chaos={"seed": 0, "specs": [spec]})
        rollbacks = global_log().count(ROLLBACK, task_id) - before
        rel = _rel_l2(runner_f.states["data_0"].params, clean)
        log(f"8f retry after {point}: {rollbacks} rollback(s); final params vs the clean "
            f"run rel L2 {rel:.3e} (tol {RETRY_REL:g})")
        if rollbacks != 1 or not rel <= RETRY_REL:
            raise AssertionError(f"8f: the run retried after {point} does not equal the "
                                 "clean run")

    def poison_edit(task):
        params = _engine_params(task)
        params["resilience"] = {"failure_policy": "retry", "quarantine_after": 1}
        _set_engine_params(task, params)
        task["operatorflow"]["operators"] = task["operatorflow"]["operators"][:1]
        return "resilience quarantine_after 1; train operator only"

    poisoned = [3, 7, 11]
    runner_g, hist_g = run_task("8g", "fedavg_mnist_mlp", dev, 2, shrink=shrink,
                                edit=poison_edit, chaos={"seed": 0, "specs": [{
                                    "point": "runner.poison_clients", "rounds": [0],
                                    "error": "nan", "payload": {"clients": poisoned}}]})
    real = runner_g.populations[0].dataset.num_real_clients
    trained = [h["train"]["data_0"]["clients_trained"] for h in hist_g]
    result = json.loads(runner_g.task_repo.get_item_value(task_id, "logical_result"))
    failed = result["logical_result"][0]["simulation_target"]["failed_num"]
    quarantined = sorted(int(c) for c in hist_g[-1]["quarantine_state"]["data_0"]["total"])
    finite = all(bool(torch.isfinite(v).all()) for v in runner_g.states["data_0"].params.values())
    log(f"8g poison {poisoned}: clients_trained per round {trained}, failed_num {failed}, "
        f"quarantined {quarantined}, params finite {finite}")
    if (trained != [real - len(poisoned)] * 2 or failed != [len(poisoned)]
            or quarantined != poisoned or not finite):
        raise AssertionError("8g: poisoned clients were not excluded and reported failed")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        resume_path(dev, tmp, runner_a, runner_d, shrink=shrink)
    log(f"phase 8 seconds: {time.perf_counter() - t_phase:.1f}")


def drop_edit_key(block, key):
    """An ``edit`` that removes one key of an engine-params block."""
    def edit(task):
        params = _engine_params(task)
        params[block].pop(key, None)
        _set_engine_params(task, params)
        return f"without {block}.{key}"
    return edit


def drop_edit(*blocks):
    """An ``edit`` that removes engine-params blocks."""
    def edit(task):
        params = _engine_params(task)
        for b in blocks:
            params.pop(b, None)
        _set_engine_params(task, params)
        return "without " + ", ".join(blocks)
    return edit


class _RobustTimer:
    """Wraps the round's robust statistics (``fedcore.robust_aggregate`` and
    ``fedcore.distance_scores``) while armed: each call is timed with CUDA
    events (on the CPU, the host clock), and the first round's inputs and
    outputs are copied to the host for the float64 oracle."""

    def __init__(self, dev):
        from olearning_sim_tpu_torch.engine import fedcore

        self.fedcore, self.dev = fedcore, dev
        self.orig = {n: getattr(fedcore, n) for n in ("robust_aggregate", "distance_scores")}
        self.calls, self.captured = [], []
        # The first round's calls under the defense config: the trimmed
        # mean, the median centre and the scores.
        self.to_capture = 3

    def _wrap(self, name):
        import torch

        fn = self.orig[name]

        def timed(*args, **kw):
            cuda = self.dev.type == "cuda"
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if cuda:
                end.record()
                self.calls.append((name, start, end))
            else:
                self.calls.append((name, t0, time.perf_counter()))
            if len(self.captured) < self.to_capture:
                host = {k: v.cpu() for k, v in args[0].items()}
                mask = args[2 if name == "distance_scores" else 1].cpu()
                res = {k: v.cpu() for k, v in out.items()} if isinstance(out, dict) else out.cpu()
                self.captured.append((name, host, mask, args[2:], res))
            return out
        return timed

    def __enter__(self):
        for n in self.orig:
            setattr(self.fedcore, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.fedcore, n, fn)

    def ms(self):
        """Milliseconds of each recorded call, in order."""
        _sync(self.dev)
        return [(n, s.elapsed_time(e) if self.dev.type == "cuda" else (e - s) * 1e3)
                for n, s, e in self.calls]


def _oracle_check(captured, trim_fraction):
    """Phase 9b's hold 1: the first round's robust aggregate, its median
    centre and the anomaly scores against float64 numpy over the same
    buffer. Returns the largest error over the tolerance."""
    import numpy as np

    worst = 0.0

    def held(what, got, ref, scale):
        nonlocal worst
        err = np.abs(got.astype(np.float64) - ref)
        tol = ORACLE_RTOL * np.abs(ref) + ORACLE_ATOL_REL * scale
        # Where the tolerance is 0 (a non-participant's score), only 0 holds.
        ratio = np.where(tol > 0, err / np.where(tol > 0, tol, 1.0),
                         np.where(err > 0, np.inf, 0.0))
        worst = max(worst, float(ratio.max()))
        log(f"9b oracle {what}: max abs err {float(err.max()):.3e}, "
            f"max |leaf| {scale:.3e}, max err/tol {float(ratio.max()):.4f}")

    def aggregate(vals, aggregator):
        n = vals.shape[0]
        s = np.sort(vals, axis=0)
        if aggregator == "median":
            return 0.5 * (s[(n - 1) // 2] + s[n // 2])
        k = int(np.floor(np.float32(trim_fraction) * np.float32(n)))
        k = min(k, max(n - 1, 0) // 2)
        return s[k:n - k].mean(axis=0)

    scored = False
    for name, host, mask, extra, res in captured:
        m = mask.numpy()
        if name == "robust_aggregate":
            aggregator = extra[0]
            for k, leaf in host.items():
                flat = leaf.reshape(leaf.shape[0], -1).numpy().astype(np.float64)
                ref = aggregate(flat[m], aggregator)
                held(f"{aggregator} {k}", res[k].reshape(-1).numpy(), ref,
                     np.abs(flat[m]).max())
        else:
            total = np.zeros(len(m))
            for k, leaf in host.items():
                flat = leaf.reshape(leaf.shape[0], -1).numpy().astype(np.float64)
                ref_c = aggregate(flat[m], "median")
                total += np.square(flat - ref_c[None, :]).sum(axis=1)
            ref = np.where(m, np.sqrt(total), 0.0)
            held("anomaly scores", res.numpy(), ref, 0.0)
            scored = True
    if not scored:
        raise AssertionError("9b: no anomaly scores were captured")
    return worst


def robust_path(dev, shrink=None):
    """Phase 9: deadline rounds (9a) and client attacks against the defense
    (9b) through the port's task bridge and runner."""
    import os
    import tempfile
    import zlib

    import numpy as np
    import torch

    from olearning_sim_tpu_torch.deviceflow import compile_trace
    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        from_config,
        make_synthetic_dataset,
        pacing,
    )
    from olearning_sim_tpu_torch.resilience import DEADLINE_MISS, ROLLBACK, global_log

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_9_")
    name = "fedavg_mnist_mlp_deadline"

    def same(label, a, b):
        diff = max(float((a[k] - b[k]).abs().max()) for k in b)
        rel = _rel_l2(a, b)
        log(f"{label}: params max abs diff {diff:g}, rel L2 {rel:g} (tol 0)")
        if diff != 0:
            raise AssertionError(f"{label}: not bitwise equal")

    def ckpt(sub, **extra):
        return params_edit(checkpoint={"directory": os.path.join(tmp.name, sub, "{task_id}"),
                                       "every": 1}, **extra)

    # 9a: the deadline config, 6 of 50 rounds.
    runner_a, hist_a = run_task("9a", name, dev, 6, shrink=shrink)
    task_id = runner_a.task_id
    for h in hist_a:
        tr = h["train"]["data_0"]
        if tr["clients_trained"] != tr["on_time"] or tr["stragglers"] != tr["selected"] - tr["on_time"]:
            raise AssertionError(f"9a round {h['round']}: the round's mask disagrees with "
                                 f"the plan: {tr}")
    log(f"9a pacing states: {[h.get('pacing') for h in hist_a]}")

    # Hold 1: round 0 against a direct round_step with the explicit on-time
    # mask, from the pacing module's plan.
    runner_0, _ = run_task("9a round 0", name, dev, 1, shrink=shrink)
    task, _ = load_task(name, 1, shrink=shrink)
    params = _engine_params(task)
    model, alg, syn = params["model"], dict(params["algorithm"]), params["data"]["synthetic"]
    cfg = FedCoreConfig.from_dict(params["fedcore"])
    shape = tuple(model["input_shape"])
    core = build_fedcore(model["name"], from_config(alg.pop("name"), **alg), cfg,
                         model_overrides=model["overrides"], input_shape=shape, device=dev)
    td = task["target"]["data"][0]
    nums = td["allocation"]["logical_simulation"]
    devices = td["total_simulation"]["devices"]
    n = sum(nums)
    ds = make_synthetic_dataset(syn["seed"], n, syn["n_local"], shape, syn["num_classes"],
                                class_sep=syn["class_sep"]).pad_for(cfg.block_clients).to(dev)
    cls = np.zeros(ds.num_clients, int)
    cls[nums[0]:n] = 1
    steps = np.full(ds.num_clients, cfg.max_local_steps, np.int64)
    for ci, dname in enumerate(devices):
        steps[cls == ci] = params["data"]["compute_profiles"][dname]
    dl = pacing.DeadlineConfig.from_dict(params["deadline"])
    trace = compile_trace(None, n, 0, task_id=task_id, operator="train", seed=0)
    stream = zlib.crc32(b"train\x00data_0")
    selected = pacing.select_cohort(trace.participate > 0, dl, 0, 0, stream=stream)
    comp = pacing.completion_times(trace.arrival_time[:n],
                                   np.minimum(steps[:n], cfg.max_local_steps), cls[:n],
                                   devices, dl, 0, 0, stream=stream)
    comp = np.where(selected, comp, np.inf).astype(np.float32)
    close = pacing.effective_deadline(comp, selected, dl, dl.deadline_s)
    on_time = np.zeros(ds.num_clients, np.float32)
    on_time[:n] = selected & (comp <= close)
    rec0 = hist_a[0]["train"]["data_0"]
    log(f"9a round 0 plan from the pacing module: selected {int(selected.sum())}, on time "
        f"{int(on_time.sum())}, close {close} s (runner: {rec0['selected']}, "
        f"{rec0['on_time']}, {rec0['deadline_s']} s)")
    if (int(selected.sum()), int(on_time.sum())) != (rec0["selected"], rec0["on_time"]):
        raise AssertionError("9a: the runner's plan is not the pacing module's")
    state = core.init_state(seed=zlib.crc32(task_id.encode()) & 0x7FFFFFFF, device=dev)
    state, _ = core.round_step(state, ds, participate=torch.from_numpy(on_time).to(dev),
                               num_steps=torch.from_numpy(steps).to(dev))
    same("9a round 0 vs direct round_step with the on-time mask",
         runner_0.states["data_0"].params, state.params)
    del runner_0, core, ds, state

    # Hold 2: a straggler spike in round 1 misses the quorum; skip_round.
    before = global_log().count(DEADLINE_MISS, task_id)
    _, hist_s = run_task("9a spike", name, dev, 3, shrink=shrink, chaos={"seed": 0, "specs": [
        {"point": "runner.straggler_spike", "rounds": [1], "payload": {"factor": 100.0}}]})
    misses = global_log().count(DEADLINE_MISS, task_id) - before
    skipped = [bool(h.get("skipped")) for h in hist_s]
    log(f"9a spike: deadline_miss events {misses}, skipped per round {skipped}")
    if misses != 1 or skipped != [False, True, False]:
        raise AssertionError("9a: the spiked round was not recorded and skipped")

    # Hold 3: stopped after round 2, resumed by a fresh runner.
    run_task("9a stop", name, dev, 6, edit=ckpt("9a"), shrink=shrink, stop_after=2)
    resumed, hist_r = run_task("9a resume", name, dev, 6, edit=ckpt("9a"), shrink=shrink)
    if _restores(resumed) != 1:
        raise AssertionError("9a: the fresh runner did not resume from the checkpoint")
    same("9a resume vs 9a", resumed.states["data_0"].params, runner_a.states["data_0"].params)
    if [h.get("pacing") for h in hist_r] != [h.get("pacing") for h in hist_a]:
        raise AssertionError("9a: the resumed run's pacing states differ")
    del resumed, runner_a

    # 9b: the defense config under the scale attack, beside a clean and an
    # attacked undefended run.
    name = "fedavg_mnist_mlp_defense"
    losses = {}
    for label, edit, chaos in (("9b clean", drop_edit("defense"), None),
                               ("9b attacked undefended", drop_edit("defense"), ATTACK_PLAN)):
        _, hist = run_task(label, name, dev, 6, edit=edit, chaos=chaos, shrink=shrink)
        losses[label] = hist[-1]["evaluate"]["data_0"]["eval_loss"]
    with _RobustTimer(dev) as timer:
        runner_b, hist_b = run_task("9b attacked defended", name, dev, 6, chaos=ATTACK_PLAN,
                                    shrink=shrink)
    losses["9b attacked defended"] = hist_b[-1]["evaluate"]["data_0"]["eval_loss"]
    RESULTS["9b"] = {"params": _host(runner_b.states["data_0"].params),
                     "quarantine": runner_b._quarantine.state_json(),
                     "peak": _peak(dev)}
    log("9b final eval loss: " + "; ".join(f"{k[3:]} {v:.6f}" for k, v in losses.items()))
    pop = runner_b.populations[0]
    n_params = sum(p.numel() for p in runner_b.states["data_0"].params.values())
    log(f"9b [C, P] delta buffer: {pop.dataset.num_clients} x {n_params} f32 = "
        f"{pop.dataset.num_clients * n_params * 4} bytes")
    calls = timer.ms()
    per_round = len(calls) // len(hist_b)
    for h, i in zip(hist_b, range(0, len(calls), per_round)):
        tr = h["train"]["data_0"]
        part = calls[i:i + per_round]
        quarantined = sorted(int(c) for c, v in
                             h["quarantine_state"]["data_0"]["remaining"].items() if v > 0)
        log(f"9b round {h['round']}: clipped={tr['clipped']} flagged={tr['flagged']} "
            f"quarantined={quarantined} robust-aggregate ms "
            f"{sum(ms for _, ms in part):.4f} ("
            + ", ".join(f"{nm} {ms:.4f}" for nm, ms in part) + ")")
    trim = _engine_params(load_task(name, 1)[0])["defense"]["trim_fraction"]
    worst = _oracle_check(timer.captured, trim)
    log(f"9b oracle: worst error / tolerance {worst:.4f} (rtol {ORACLE_RTOL:g}, atol "
        f"{ORACLE_ATOL_REL:g} x max|leaf|)")
    if not worst <= 1.0:
        raise AssertionError("9b: the card's robust statistics disagree with the oracle")
    qa = _engine_params(load_task(name, 1)[0])["resilience"]["quarantine_after"]
    total = set(int(c) for c in hist_b[qa - 1]["quarantine_state"]["data_0"]["total"])
    log(f"9b: quarantined by round {qa - 1} (quarantine_after {qa}): {sorted(total)}; "
        f"attackers {ATTACKERS}")
    if not set(ATTACKERS) <= total:
        raise AssertionError("9b: an attacker was not quarantined in time")

    # Hold 3: a preemption after round 2 trained, recovered from round 1's
    # checkpoint under a retry policy, against the uninterrupted run.
    retry = {"failure_policy": "retry", "quarantine_after": qa, "readmit_after": 5}
    before = global_log().count(ROLLBACK, runner_b.task_id)
    runner_p, hist_p = run_task("9b preempt", name, dev, 6, shrink=shrink,
                                edit=ckpt("9b", resilience=retry), chaos={
                                    "seed": 0, "specs": ATTACK_PLAN["specs"] + [
                                        {"point": "runner.pre_checkpoint", "rounds": [2],
                                         "error": "preempt"}]})
    rollbacks = global_log().count(ROLLBACK, runner_b.task_id) - before
    log(f"9b preempt: {rollbacks} rollback(s), {_restores(runner_p)} restore(s)")
    if rollbacks != 1 or _restores(runner_p) != 1:
        raise AssertionError("9b: the preemption was not recovered through the checkpoint")
    same("9b preempt vs 9b", runner_p.states["data_0"].params,
         runner_b.states["data_0"].params)
    if runner_p._quarantine.state_json() != runner_b._quarantine.state_json():
        raise AssertionError("9b: the recovered run's quarantine state differs")
    tmp.cleanup()
    log(f"phase 9 seconds: {time.perf_counter() - t_phase:.1f}")


def bf16_card_vs_cpu(dev, label, family, alg, cfg, shape, host, num_steps=None):
    """Phase 10d: one round of 8 clients of ``family`` on the card and on
    the CPU with the same params, data and indices. In f32 compute (the
    model's ``dtype`` override) the two are held within FAMILY_F32_REL; in
    bf16 compute, which the family runs, the card's move must lie no
    farther from the CPU's f32 move than BF16_NOISE_RATIO times the CPU's
    own bf16 move."""
    import torch

    cpu = torch.device("cpu")
    draws = []
    f32 = {"dtype": torch.float32}
    runs, secs = {}, []
    for key, where, over in (("card f32", dev, f32), ("cpu f32", cpu, f32),
                             ("card bf16", dev, None), ("cpu bf16", cpu, None)):
        t0 = time.perf_counter()
        runs[key] = _moved_on(where, family, alg, cfg, shape, host, draws, num_steps, 1, over)
        secs.append(f"{key} {time.perf_counter() - t0:.1f} s")
    ref = runs["cpu f32"][0]
    gaps = {key: {g: rel for g, rel, _ in _group_gaps(runs[key][0], ref)}
            for key in ("card f32", "card bf16", "cpu bf16")}
    ok = all(rel <= FAMILY_F32_REL for rel in gaps["card f32"].values())
    ok = ok and all(gaps["card bf16"][g] <= BF16_NOISE_RATIO * gaps["cpu bf16"][g]
                    for g in gaps["cpu bf16"])
    log(f"10d card vs CPU, {label}: mean_loss " + ", ".join(
        f"{key} {run[1]:.6f}" for key, run in runs.items()) + "; " + "; ".join(
        f"{g}: card f32 rel L2 {gaps['card f32'][g]:.3e} (tol {FAMILY_F32_REL:g}), bf16 "
        f"moves from the CPU's f32 move: card {gaps['card bf16'][g]:.3e}, CPU "
        f"{gaps['cpu bf16'][g]:.3e} (card at most {BF16_NOISE_RATIO:g}x the CPU's)"
        for g in gaps["cpu bf16"]) + f" ({', '.join(secs)}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"10d {label}: the round on the card disagrees with the CPU's")


def families_path(dev, shrink=None):
    """Phase 10: the remaining families, resnet18, vit_tiny and moe_text."""
    import torch

    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        ditto,
        fedavg,
        fedprox,
        make_central_text_eval_set,
        make_synthetic_dataset,
        make_synthetic_text_dataset,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    # 10a: the FedProx config at its published width, block 64 uncut.
    runner_a, hist_a = run_task("10a", "fedprox_femnist_resnet18", dev, 2,
                                clients=RESNET_CLIENTS, shrink=shrink)
    if not any(h["train"]["data_0"]["dropped"] > 0 for h in hist_a):
        raise AssertionError("10a: the flow_dispatch strategy dropped no client")

    # 10b: the Ditto config at its published width; bf16 personal params.
    runner_b, _ = run_task("10b", "ditto_cifar100_vit", dev, 2,
                           clients=VIT_CLIENTS, shrink=shrink)
    pop = runner_b.populations[0]
    personal = runner_b.personal_states["data_0"].params
    p_loss, p_acc = runner_b.core.evaluate_personal(runner_b.personal_states["data_0"],
                                                    pop.dataset)
    if not math.isfinite(p_loss):
        raise AssertionError(f"10b: evaluate_personal loss {p_loss}")
    per_client = sum(v[0].numel() * v.element_size() for v in personal.values())
    dtypes = sorted({str(v.dtype) for v in personal.values()})
    log(f"10b evaluate_personal over {pop.dataset.num_real_clients} clients: loss "
        f"{p_loss:.6f} acc {p_acc:.4f}; personal state {dtypes} "
        f"{per_client * pop.dataset.num_clients} bytes for {pop.dataset.num_clients} padded "
        f"clients, {per_client} per client; the config's 10,000 clients (10,016 padded to "
        f"its block of 32): {per_client * 10016 / 1e9:.3f} GB")

    # 10c: moe_text at its registry defaults through build_fedcore.
    cfg = FedCoreConfig(batch_size=16, max_local_steps=2, block_clients=16,
                        eval_batch_size=MOE_EVAL_BATCH, aux_loss_weight=0.01)
    core = build_fedcore("moe_text", fedavg(0.05), cfg, input_shape=(64,), device=dev)
    log(f"10c moe_text: registry defaults, L 64, {MOE_CLIENTS} synthetic text clients of 64 "
        f"rows, eval_batch_size {MOE_EVAL_BATCH} (each eval batch's [S, E, capacity] "
        f"dispatch grows as its token count squared: 0.67 GB at 256 rows, 10.7 GB at 1024)")
    ds = make_synthetic_text_dataset(0, MOE_CLIENTS, 64, 64, 2).pad_for(16).to(dev)
    state, _ = fl_rounds("10c moe_text", core, ds, dev, 2,
                         *make_central_text_eval_set(0, 2048, 64, 2))
    with torch.no_grad():
        _, aux = torch.func.functional_call(core.model, state.params, (ds.x[0, :16],),
                                            {"return_aux": True})
    if not (math.isfinite(float(aux)) and float(aux) > 0):
        raise AssertionError(f"10c: aux loss {float(aux)}")
    log(f"10c aux loss of client 0's first 16 rows after the rounds: {float(aux):.6f} "
        f"(weighted by aux_loss_weight {cfg.aux_loss_weight} in every client's loss)")
    del ds, state, core

    # 10d: each family on 8 clients, card against CPU.
    small = dict(batch_size=4, max_local_steps=2, block_clients=8)
    log(f"10d: 8 clients, published widths, batch {small['batch_size']}, "
        f"{small['max_local_steps']} local steps, one round")
    bf16_card_vs_cpu(dev, "resnet18 FedProx", "resnet18", fedprox(0.03, mu=0.1),
                     FedCoreConfig(**small), (28, 28, 1),
                     make_synthetic_dataset(0, 8, 16, (28, 28, 1), 62, dirichlet_alpha=0.3))
    bf16_card_vs_cpu(dev, "vit_tiny Ditto", "vit_tiny", ditto(0.03, lam=0.1),
                     FedCoreConfig(**small, personal_dtype=torch.bfloat16), (32, 32, 3),
                     make_synthetic_dataset(0, 8, 16, (32, 32, 3), 100, dirichlet_alpha=0.5),
                     num_steps=torch.tensor([2, 2, 2, 1, 1, 1, 1, 0]))
    bf16_card_vs_cpu(dev, "moe_text FedAvg + aux", "moe_text", fedavg(0.05),
                     FedCoreConfig(**small), (64,),
                     make_synthetic_text_dataset(0, 8, 16, 64, 2))

    # 10e: one round of 10a under the profiler, after an unprofiled one
    # for the idle share's wall time.
    if dev.type == "cuda":
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "profile_torch_port", ROOT / "scripts" / "profile_torch_port.py")
        profiler = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(profiler)
        core, pop = runner_a.core, runner_a.populations[0]
        state = runner_a.states["data_0"]

        def one_round():
            core.round_step(state, pop.dataset)
            torch.cuda.synchronize()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_round()
        steady = time.perf_counter() - t0
        log(f"10e: {card_line()}")
        profiler.profile("10e resnet18 round (128 clients, block 64)", one_round, None,
                         top=5, steady_s=steady)
    log(f"phase 10 seconds: {time.perf_counter() - t_phase:.1f}")


# Phase 11b's population, one count per device class of the trace config:
# two stream blocks of its stream_block_rows (2048), the least that
# exercises the double buffering.
STREAM_CLIENTS = (2048, 2048)


def _stream_lines(label, hist, peaks):
    """Per round: the scenario's counts, clients trained, the stream record
    and the step's peak device memory."""
    for h, peak in zip(hist, peaks):
        tr = h["train"]["data_0"]
        mem = "not measured (cpu)" if peak is None else f"{peak / 2**30:.4f} GiB"
        log(f"{label} round {h['round']}: scenario {json.dumps(tr['scenario'])} "
            f"clients_trained={tr['clients_trained']} stream "
            f"{json.dumps(tr.get('stream'))} peak device memory {mem}")


def stream_path(dev, shrink=None):
    """Phase 11: scenario traces and block-streamed rounds through the
    port's task bridge and runner (no kernel of the repo is on this path:
    mlp2 is torch matrix products and elementwise ops, the staging is
    copies)."""
    import os
    import tempfile

    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from olearning_sim_tpu_torch.resilience import HostPreemption, faults

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_11_")
    name = "fedavg_mnist_mlp_trace"
    resident = drop_edit_key("scenario", "stream_block_rows")
    gib = lambda v: "not measured (cpu)" if v is None else f"{v / 2**30:.4f} GiB"

    def same(label, a, b):
        diff = max(float((a[k] - b[k]).abs().max()) for k in b)
        log(f"{label}: params max abs diff {diff:g} (tol 0)")
        if diff != 0 or not all(bool((a[k] == b[k]).all()) for k in b):
            raise AssertionError(f"{label}: not bitwise equal")

    # 11a: the trace config at its published width and population, 3 of 50
    # rounds, streamed; then resident (the same JSON without
    # stream_block_rows: the scenario's masks and drift stay live).
    peaks_s, peaks_r = [], []
    runner_s, hist_s = run_task("11a streamed", name, dev, 3, shrink=shrink, peaks=peaks_s)
    RESULTS["11a"] = {"params": _host(runner_s.states["data_0"].params)}
    _stream_lines("11a streamed", hist_s, peaks_s)
    runner_r, hist_r = run_task("11a resident", name, dev, 3, shrink=shrink, edit=resident,
                                peaks=peaks_r)
    _stream_lines("11a resident", hist_r, peaks_r)
    for hs, hr in zip(hist_s, hist_r):
        a, b = hs["train"]["data_0"], hr["train"]["data_0"]
        if (a["scenario"], a["clients_trained"], a["mean_loss"]) != \
                (b["scenario"], b["clients_trained"], b["mean_loss"]):
            raise AssertionError(f"11a round {hs['round']}: streamed {a} vs resident {b}")
    same("11a streamed vs resident", runner_s.states["data_0"].params,
         runner_r.states["data_0"].params)
    del runner_r

    # 11b: two stream blocks (clients cut up to STREAM_CLIENTS), streamed
    # and resident, one round each.
    peaks_b, peaks_c = [], []
    runner_b, hist_b = run_task("11b streamed", name, dev, 1, clients=STREAM_CLIENTS,
                                shrink=shrink, peaks=peaks_b)
    _stream_lines("11b streamed", hist_b, peaks_b)
    runner_c, _ = run_task("11b resident", name, dev, 1, clients=STREAM_CLIENTS,
                           shrink=shrink, edit=resident, peaks=peaks_c)
    same("11b streamed vs resident", runner_b.states["data_0"].params,
         runner_c.states["data_0"].params)
    del runner_c
    for h in hist_b:
        if h["train"]["data_0"]["stream"]["blocks"] < 2:
            raise AssertionError(f"11b round {h['round']}: fewer than 2 stream blocks")
    log(f"11b peak device memory per round: streamed {[gib(v) for v in peaks_b]}, resident "
        f"{[gib(v) for v in peaks_c]}; 11a streamed {[gib(v) for v in peaks_s]}, resident "
        f"{[gib(v) for v in peaks_r]}")
    del runner_b

    # 11c: 11a with a checkpoint every round, preempted at the start of
    # round 2 (under fail_task, so that the preemption ends the process's
    # run instead of being skipped), then a fresh runner with the config's
    # own resilience block over the same directory.
    ckpt = params_edit(checkpoint={"directory": os.path.join(tmp.name, "{task_id}"),
                                   "every": 1})
    resilience = _engine_params(load_task(name, 1)[0])["resilience"]
    task, cuts = load_task(name, 3, shrink=shrink, edit=_edits(ckpt, params_edit(
        resilience=dict(resilience, failure_policy="fail_task"))))
    log(f"11c {name}: " + "; ".join(cuts) + "; a host preemption at round 2's start")
    first = build_runner_from_taskconfig(task, device=dev)
    plan = {"seed": 0, "specs": [{"point": "runner.round_begin", "rounds": [2],
                                  "error": "preempt"}]}
    preempted = False
    with faults.chaos(faults.FaultPlan.from_dict(plan)):
        first.begin()
        try:
            while first.step():
                pass
        except HostPreemption:
            preempted = True
    first.checkpointer.wait()
    if not preempted or len(first.history) != 2:
        raise AssertionError(f"11c: preempted {preempted} after {len(first.history)} rounds")
    del first
    resumed, _ = run_task("11c resume", name, dev, 3, edit=ckpt, shrink=shrink)
    if _restores(resumed) != 1:
        raise AssertionError("11c: the fresh runner did not resume from the checkpoint")
    same("11c resume vs 11a", resumed.states["data_0"].params, runner_s.states["data_0"].params)
    tmp.cleanup()
    log(f"phase 11 seconds: {time.perf_counter() - t_phase:.1f}")


# Phase 12's record fields held exactly, card against CPU and run against
# run (the host decides them: the plan, the dispatch trace, the finiteness
# of each client's loss).
ASYNC_HOST_KEYS = ("released", "dropped", "clients_trained", "commits", "committed",
                   "stale_dropped", "buffer_size", "windows", "idle_s", "commit_clock",
                   "round_close_s", "clipped", "flagged")


class _RoundCapture:
    """Wraps a runner's ``core.round_step``: keeps each call's async plan,
    participation and returned metrics, so the run's stale drops and
    anomaly scores can be read back."""

    def __init__(self, runner):
        self.calls = []
        step = runner.core.round_step

        def capture(state, ds, **kw):
            out = step(state, ds, **kw)
            self.calls.append((kw.get("async_plan"), kw.get("participate"), ds.weight, out[1]))
            return out

        runner.core.round_step = capture


def async_path(dev, shrink=None):
    """Phase 12: buffered async rounds (12a-12c), the sharded server update
    at a world of one (12d) and the multi-task dispatcher (12e), through the
    port's task bridge and runner (no kernel of the repo is on this path:
    mlp2 is torch matrix products and elementwise ops, the window sums a
    matrix product, the robust statistics ``torch.sort``)."""
    import os
    import tempfile
    import zlib

    import numpy as np
    import torch

    from olearning_sim_tpu_torch.engine.runner import MultiTaskDispatcher
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from olearning_sim_tpu_torch.resilience import HostPreemption, faults
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_12_")
    name = "fedavg_mnist_mlp_async"
    cpu = torch.device("cpu")

    def same(label, a, b):
        diff = max(float((a[k] - b[k]).abs().max()) for k in b)
        log(f"{label}: params max abs diff {diff:g} (tol 0)")
        if diff != 0 or not all(bool((a[k] == b[k]).all()) for k in b):
            raise AssertionError(f"{label}: not bitwise equal")

    def host_records(hist):
        return [(h.get("async_clock"), h.get("quarantine_state"),
                 {k: h["train"]["data_0"].get(k) for k in ASYNC_HOST_KEYS}) for h in hist]

    def init_params(runner):
        seed = zlib.crc32(runner.task_id.encode()) & 0x7FFFFFFF
        return runner.core.init_state(seed=seed, device="cpu").params

    def card_vs_cpu_hold(label, runner, hist, runner_cpu, hist_cpu):
        if host_records(hist) != host_records(hist_cpu):
            raise AssertionError(f"{label}: host outputs differ from the CPU run's: "
                                 f"{host_records(hist)} vs {host_records(hist_cpu)}")
        init = init_params(runner)
        card = {k: v.cpu() - init[k] for k, v in runner.states["data_0"].params.items()}
        host = {k: v - init[k] for k, v in runner_cpu.states["data_0"].params.items()}
        rel = _rel_l2(card, host)
        log(f"{label}: host outputs equal the CPU run's; the run's move vs the CPU's rel L2 "
            f"{rel:.3e} (tol {CARD_CPU_REL:g})")
        if not rel <= CARD_CPU_REL:
            raise AssertionError(f"{label}: the card's run moved away from the CPU's")

    # 12a: the async config at its published width and population, 3 of 50
    # rounds, twice on the card (bitwise: the window sums are a matrix
    # product, no atomics) and once on the CPU.
    peaks = []
    runner_a, hist_a = run_task("12a", name, dev, 3, shrink=shrink, peaks=peaks)
    RESULTS["12a"] = {"params": _host(runner_a.states["data_0"].params)}
    mem = ["not measured (cpu)" if v is None else f"{v / 2**30:.4f} GiB" for v in peaks]
    log(f"12a peak device memory per round: {mem}")
    P = sum(v.numel() for v in runner_a.states["data_0"].params.values())
    W = hist_a[0]["train"]["data_0"]["windows"]
    log(f"12a window buffer: W {W} x P {P} x 4 = {W * P * 4} bytes; async clock per round "
        f"{[h['async_clock'] for h in hist_a]}")
    runner_a2, hist_a2 = run_task("12a again", name, dev, 3, shrink=shrink)
    if host_records(hist_a2) != host_records(hist_a) or \
            [h["train"]["data_0"]["mean_loss"] for h in hist_a2] != \
            [h["train"]["data_0"]["mean_loss"] for h in hist_a]:
        raise AssertionError("12a: the second run's records differ")
    same("12a run vs run (determinism)", runner_a2.states["data_0"].params,
         runner_a.states["data_0"].params)
    del runner_a2
    runner_c, hist_c = run_task("12a cpu", name, cpu, 3, shrink=shrink)
    card_vs_cpu_hold("12a card vs cpu", runner_a, hist_a, runner_c, hist_c)
    del runner_c

    # 12b: max_staleness 1 (windows 2-3 dropped), the score schedule, a
    # scale -8 attack on four clients and a trimmed mean with anomaly
    # scores; 2 rounds on the card and on the CPU.
    def compose(task):
        params = _engine_params(task)
        params["async"].update(max_staleness=1, schedule="score")
        params["defense"] = {"aggregator": "trimmed_mean", "trim_fraction": 0.1,
                             "anomaly_threshold": 4.0}
        _set_engine_params(task, params)
        return f"async {json.dumps(params['async'])}; defense {json.dumps(params['defense'])}"

    runs = {}
    for where in (dev, cpu):
        task, cuts = load_task(name, 2, edit=compose, shrink=shrink)
        label = "12b" if where.type != "cpu" else "12b cpu"
        log(f"{label} {name}: " + "; ".join(cuts) + f"; fault plan {json.dumps(ATTACK_PLAN)}")
        runner = build_runner_from_taskconfig(task, device=where)
        cap = _RoundCapture(runner)
        with faults.chaos(faults.FaultPlan.from_dict(ATTACK_PLAN)):
            hist = runner.run()
        for h, (plan, part, weight, metrics) in zip(hist, cap.calls):
            tr = h["train"]["data_0"]
            active = (part.cpu().numpy() > 0) & (weight.cpu().numpy() > 0)
            want = int((plan.stale_dropped_mask() & active).sum())
            log(f"{label} round {h['round']}: " + " ".join(
                f"{k}={tr.get(k)}" for k in ASYNC_HOST_KEYS) + f" plan stale-dropped {want}")
            if tr["stale_dropped"] != want or want == 0:
                raise AssertionError(f"{label}: stale_dropped {tr['stale_dropped']} is not the "
                                     f"plan's {want}")
        runs[where.type] = (runner, hist, [m.anomaly_score.cpu() for *_, m in cap.calls])
    (runner_b, hist_b, scores_b), (runner_bc, hist_bc, scores_bc) = runs[dev.type], runs["cpu"]
    card_vs_cpu_hold("12b card vs cpu", runner_b, hist_b, runner_bc, hist_bc)
    for r, (a, b) in enumerate(zip(scores_b, scores_bc)):
        part = b > 0
        rel = float(((a - b).abs()[part] / b[part]).max())
        log(f"12b round {r} anomaly scores: {int(part.sum())} scored, attackers "
            f"{[round(float(a[c]), 4) for c in ATTACKERS]}, median "
            f"{float(a[part].median()):.4f}; card vs cpu max rel {rel:.3e} "
            f"(tol {CARD_CPU_REL:g})")
        if not bool(torch.equal(a > 0, part)) or not rel <= CARD_CPU_REL:
            raise AssertionError(f"12b round {r}: the card's anomaly scores differ")
    del runs, runner_b, runner_bc

    # 12c: 12a with a checkpoint every round, a host preemption at round
    # 2's start (fail_task, so it ends the run), and a fresh runner over the
    # same directory.
    ckpt = params_edit(checkpoint={"directory": os.path.join(tmp.name, "{task_id}"),
                                   "every": 1})
    resilience = _engine_params(load_task(name, 1)[0])["resilience"]
    task, cuts = load_task(name, 3, shrink=shrink, edit=_edits(ckpt, params_edit(
        resilience=dict(resilience, failure_policy="fail_task"))))
    log(f"12c {name}: " + "; ".join(cuts) + "; a host preemption at round 2's start")
    first = build_runner_from_taskconfig(task, device=dev)
    plan = {"seed": 0, "specs": [{"point": "runner.round_begin", "rounds": [2],
                                  "error": "preempt"}]}
    preempted = False
    with faults.chaos(faults.FaultPlan.from_dict(plan)):
        first.begin()
        try:
            while first.step():
                pass
        except HostPreemption:
            preempted = True
    first.checkpointer.wait()
    if not preempted or len(first.history) != 2:
        raise AssertionError(f"12c: preempted {preempted} after {len(first.history)} rounds")
    del first
    resumed, hist_r = run_task("12c resume", name, dev, 3, edit=ckpt, shrink=shrink)
    if _restores(resumed) != 1:
        raise AssertionError("12c: the fresh runner did not resume from the checkpoint")
    if host_records(hist_r) != host_records(hist_a):
        raise AssertionError("12c: the resumed run's records (async_clock included) differ")
    same("12c resume vs 12a", resumed.states["data_0"].params, runner_a.states["data_0"].params)
    del resumed

    # 12d: the bf16 config whole (shard_server_update true), 3 rounds,
    # against the same JSON with the key false; then one FedAdam round of
    # mlp2, whose moments live on the flat coordinates.
    def shard(on, fedadam=False):
        def edit(task):
            params = _engine_params(task)
            params["fedcore"]["shard_server_update"] = on
            if fedadam:
                params["algorithm"] = {"name": "fedadam", "local_lr": 0.05, "server_lr": 0.01}
            _set_engine_params(task, params)
            return f"shard_server_update {on}" + ("; fedadam server_lr 0.01" if fedadam else "")
        return edit

    bf16 = "fedavg_mnist_mlp_bf16"
    for rounds, fedadam in ((3, False), (1, True)):
        sharded, _ = run_task("12d sharded", bf16, dev, rounds, shrink=shrink,
                              edit=shard(True, fedadam))
        if not fedadam:
            RESULTS["12d"] = {"params": _host(sharded.states["data_0"].params)}
        replicated, _ = run_task("12d replicated", bf16, dev, rounds, shrink=shrink,
                                 edit=shard(False, fedadam))
        so, ro = sharded.states["data_0"].opt_state, replicated.states["data_0"].opt_state
        log(f"12d optimizer state: sharded "
            f"{ {k: [tuple(t.shape) for t in v.values()][:2] for k, v in so.items() if isinstance(v, dict)} }"
            f" vs replicated "
            f"{ {k: [tuple(t.shape) for t in v.values()][:2] for k, v in ro.items() if isinstance(v, dict)} }")
        same(f"12d sharded vs replicated{' (fedadam)' if fedadam else ''}",
             sharded.states["data_0"].params, replicated.states["data_0"].params)
        for m in ("mu", "nu") if fedadam else ():
            same(f"12d fedadam {m}", {k: v.reshape(-1) for k, v in so[m].items()},
                 {k: v.reshape(-1) for k, v in ro[m].items()})
        del sharded, replicated

    # 12e: 12a's task and fedavg_mnist_mlp, 3 rounds each, under the
    # dispatcher in turns and on threads, with a port task repo holding the
    # leases; each task bitwise its solo run.
    names = (name, "fedavg_mnist_mlp")

    def build(repo=None):
        out = []
        for n in names:
            task, cuts = load_task(n, 3, shrink=shrink)
            out.append(build_runner_from_taskconfig(task, task_repo=repo, device=dev))
        return out

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        return time.perf_counter() - t0

    solo = build()
    secs = timed(lambda: [r.run() for r in solo])
    rates = {"sequential (solo, back to back)": 6 / secs}
    for mode in ("step", "thread"):
        repo = TaskTableRepo()
        runners = build(repo)
        disp = MultiTaskDispatcher(runners, task_repo=repo, interleave=mode)
        secs = timed(disp.run)
        rates[f"dispatched ({mode})"] = 6 / secs
        leases = [repo.lease_info(r.task_id)[0] for r in runners]
        log(f"12e {mode}: {secs:.4f} s for 6 rounds, fenced {disp.fenced}, leases after "
            f"{leases}")
        if disp.fenced or any(leases):
            raise AssertionError(f"12e {mode}: a lease was fenced or left held")
        for r, s in zip(runners, solo):
            if host_records(r.history) != host_records(s.history):
                raise AssertionError(f"12e {mode} {r.task_id}: records differ from the solo run")
            same(f"12e {mode} {r.task_id} vs solo", r.states["data_0"].params,
                 s.states["data_0"].params)
    # Two runners sharing one FedCore on threads (each thread trains in a
    # module skeleton of its own), each bitwise its solo run.
    shared = []
    for suffix in ("a", "b"):
        task, _ = load_task("fedavg_mnist_mlp", 3, shrink=shrink)
        task["task_id"] += f"_shared_{suffix}"
        shared.append(build_runner_from_taskconfig(task, device=dev))
    alone = [build_runner_from_taskconfig(
        dict(load_task("fedavg_mnist_mlp", 3, shrink=shrink)[0], task_id=r.task_id),
        device=dev) for r in shared]
    for r in alone:
        r.run()
    shared[1].core = shared[0].core
    MultiTaskDispatcher(shared, interleave="thread").run()
    for r, s in zip(shared, alone):
        same(f"12e thread, one shared core, {r.task_id} vs solo", r.states["data_0"].params,
             s.states["data_0"].params)
    card = card_line() if dev.type == "cuda" else "cpu"
    log("12e aggregate rounds/sec: " + "; ".join(f"{k} {v:.4f}" for k, v in rates.items())
        + f"; thread / sequential {rates['dispatched (thread)'] / rates['sequential (solo, back to back)']:.3f}"
        + f" | {card}")
    tmp.cleanup()
    log(f"phase 12 seconds: {time.perf_counter() - t_phase:.1f}")


def _peak(dev):
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _held(label, got, want, atol=0.0):
    """``got``'s params against ``want``'s: bitwise when ``atol`` is 0,
    else within ``atol`` (max abs); prints the largest difference."""
    import torch

    diff = max(float((got[k].cpu() - want[k].cpu()).abs().max()) for k in want)
    log(f"{label}: params max abs diff {diff:g} (tol {atol:g})")
    exact = all(torch.equal(got[k].cpu(), want[k].cpu()) for k in want)
    if (atol == 0 and not exact) or not diff <= atol:
        raise AssertionError(f"{label}: params differ")


# Phase 13b's tasks per rank: (label, config, rounds, engine-params edit).
DP_TASKS = (("8a", "fedavg_mnist_mlp", 3), ("9b", "fedavg_mnist_mlp_defense", 6),
            ("12a", "fedavg_mnist_mlp_async", 3), ("12d", "fedavg_mnist_mlp_bf16", 3))
# Phase 13b, a mean-aggregated dp-2 run against the dp-1 run on the card:
# the two add the ranks' partial sums in another order, and the CPU tests
# hold the port at dp 2 to JAX's dp 2 within this (test_torch_dp.py).
DP_PARAM_ATOL = 1e-3
DP_TIMEOUT_S = 420


def _dp_rank(rank, world, store_path, out_dir, ckpt_dir, dev_type, shrink):
    """Phase 13b on one rank (a spawned process): the tasks of DP_TASKS
    over a gloo group of ``world`` ranks, all on card 0 (or the CPU in a
    rehearsal), then a resume; results as a torch file per rank. Rank 0
    alone prints."""
    import contextlib
    import io
    import os

    import torch
    import torch.distributed as dist

    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from olearning_sim_tpu_torch.parallel import collectives
    from olearning_sim_tpu_torch.resilience import HostPreemption, faults

    dev = torch.device("cpu")
    if dev_type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    quiet = contextlib.redirect_stdout(io.StringIO()) if rank else contextlib.nullcontext()
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    out = {}
    try:
        with quiet:
            for label, name, rounds in DP_TASKS:
                chaos = ATTACK_PLAN if label == "9b" else None
                collectives.reset_bytes()
                runner, hist = run_task(f"13b {label} dp {world} gloo", name, dev, rounds,
                                        chaos=chaos, shrink=shrink)
                if runner.core.dp != world:
                    raise AssertionError(f"13b {label}: the bridge's plan has dp "
                                         f"{runner.core.dp}, not the world's {world}")
                out[label] = {"params": _host(runner.states["data_0"].params),
                              "history": json.dumps(hist, sort_keys=True, default=float),
                              "peak": _peak(dev), "bytes": dict(collectives.BYTES),
                              "quarantine": (runner._quarantine.state_json()
                                             if runner._quarantine is not None else None)}
                if label == "12d":
                    replicated, _ = run_task(f"13b 12d replicated dp {world} gloo", name, dev,
                                             rounds, shrink=shrink, edit=_shard_edit(False))
                    out["12d replicated"] = {"params": _host(replicated.states["data_0"]
                                                             .params)}
            # A resume at dp 2, as 12c: 12a with a checkpoint every round, a
            # host preemption at round 2's start ending the run, a fresh
            # runner.
            ckpt = params_edit(checkpoint={"directory": os.path.join(ckpt_dir, "{task_id}"),
                                           "every": 1})
            resilience = _engine_params(load_task("fedavg_mnist_mlp_async", 1)[0])["resilience"]
            task, _ = load_task("fedavg_mnist_mlp_async", 3, shrink=shrink, edit=_edits(
                ckpt, params_edit(resilience=dict(resilience, failure_policy="fail_task"))))
            first = build_runner_from_taskconfig(task, device=dev)
            plan = {"seed": 0, "specs": [{"point": "runner.round_begin", "rounds": [2],
                                          "error": "preempt"}]}
            with faults.chaos(faults.FaultPlan.from_dict(plan)):
                first.begin()
                with contextlib.suppress(HostPreemption):
                    while first.step():
                        pass
            first.checkpointer.wait()
            resumed, hist = run_task(f"13b resume dp {world} gloo", "fedavg_mnist_mlp_async", dev,
                                     3, edit=ckpt, shrink=shrink)
            out["resume"] = {"params": _host(resumed.states["data_0"].params),
                             "start": len(first.history),
                             "history": json.dumps(hist, sort_keys=True, default=float)}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _shard_edit(on):
    def edit(task):
        params = _engine_params(task)
        params["fedcore"]["shard_server_update"] = on
        _set_engine_params(task, params)
        return f"shard_server_update {on}"
    return edit


def dp_path(dev, shrink=None):
    """Phase 13: the port's round data-parallel over ``torch.distributed``
    (no kernel of the repo is on this path: the collectives are NCCL's and
    gloo's). 13a runs earlier phases' paths under an NCCL group of one rank,
    so every collective of the round launches on the card, each bitwise its
    earlier run with no group; 13b runs two ranks on the one card over gloo
    (NCCL refuses two ranks on one card) against the dp-1 runs."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from olearning_sim_tpu_torch.parallel import collectives
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    t_phase = time.perf_counter()
    card = card_line() if dev.type == "cuda" else "cpu"
    backend = "nccl" if dev.type == "cuda" else "gloo"

    # 13a: an NCCL group of one rank.
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    plan = make_mesh_plan()
    log(f"13a: {dist.get_backend()} group of {dist.get_world_size()} rank; plan dp {plan.dp}, "
        f"dp group {'set' if plan.dp_group is not None else 'none'}")
    if plan.dp_group is None:
        raise AssertionError("13a: the plan over an initialised group has no dp group")

    def traffic(label, rounds):
        per = {k: v // rounds for k, v in collectives.BYTES.items() if v}
        log(f"13a {label}: bytes handed to the backend per round {per}")
        if not per:
            raise AssertionError(f"13a {label}: no collective launched")

    if shrink is None:
        collectives.reset_bytes()
        _, state, times = distilbert_rounds(dev, "13a 4 round")
        _held(f"13a 4 ({backend} group of one) vs phase 4 (no group)", state.params,
              RESULTS["4"]["params"])
        log(f"13a 4 rounds/sec (round 1): {backend} group of one {1.0 / times[1]:.4f}, no group "
            f"{1.0 / RESULTS['4']['seconds'][1]:.4f} | {card}")
        traffic("4", 2)
        del state
        # Within one process and one state: round 0 from the same params,
        # in turns with no group and with the group, and the psum of the
        # round's sums alone (CUDA events).
        from olearning_sim_tpu_torch.parallel.mesh import MeshPlan

        core_g, ds = distilbert_setup(dev, make_mesh_plan())
        core_n, _ = distilbert_setup(dev, MeshPlan(dp=1, sp=1, rank=0))
        state0 = core_n.init_state(seed=0, device=dev)
        secs, outs = {"no group": [], backend: []}, {}
        for _ in range(3):
            for name, core in (("no group", core_n), (backend, core_g)):
                _sync(dev)
                t0 = time.perf_counter()
                st, m = core.round_step(state0, ds)
                float(m.mean_loss)
                _sync(dev)
                secs[name].append(time.perf_counter() - t0)
                outs[name] = st.params
        _held(f"13a 4 round 0 ({backend} group of one) vs no group, in turns", outs[backend],
              outs["no group"])
        sums = [torch.zeros_like(v) for v in state0.params.values()] + \
            [torch.zeros((), device=v.device) for v in list(state0.params.values())[:4]]
        psum_ms = sorted(cuda_time_ms(lambda: collectives.psum(sums, plan.dp_group), iters=5,
                                      warmup=1) for _ in range(3))
        log(f"13a 4 round seconds in turns: " + "; ".join(
            f"{k} {[round(v, 4) for v in vs]} (median {sorted(vs)[1]:.4f})"
            for k, vs in secs.items())
            + f"; the round's psum alone {psum_ms[1]:.4f} ms | {card}")
        del core_g, core_n, state0, outs, sums, st, m, ds
    for label, name, rounds, chaos in (("8a", "fedavg_mnist_mlp", 3, None),
                                       ("9b", "fedavg_mnist_mlp_defense", 6, ATTACK_PLAN),
                                       ("11a", "fedavg_mnist_mlp_trace", 3, None),
                                       ("12a", "fedavg_mnist_mlp_async", 3, None),
                                       ("12d", "fedavg_mnist_mlp_bf16", 3, None)):
        collectives.reset_bytes()
        runner, _ = run_task(f"13a {label}", name, dev, rounds, chaos=chaos, shrink=shrink,
                             edit=_shard_edit(True) if label == "12d" else None)
        _held(f"13a {label} ({backend} group of one) vs {label} (no group)",
              runner.states["data_0"].params, RESULTS[label]["params"])
        if label == "9b" and runner._quarantine.state_json() != RESULTS["9b"]["quarantine"]:
            raise AssertionError("13a 9b: the quarantine state differs")
        traffic(label, rounds)
        del runner
    dist.destroy_process_group()
    log(f"13a: group destroyed; initialised {dist.is_initialized()}")

    # 13b: two ranks over gloo on the one card.
    world = 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_13_") as work:
        ckpt_dir = tempfile.mkdtemp(dir=work)
        t0 = time.perf_counter()
        ctx = tmp.start_processes(_dp_rank, args=(world, f"{work}/store", work, ckpt_dir,
                                                  dev.type, shrink),
                                  nprocs=world, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1):
                if time.perf_counter() - t0 > DP_TIMEOUT_S:
                    raise AssertionError(f"13b: the ranks passed {DP_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
        ranks = [torch.load(f"{work}/rank{r}.pt", weights_only=False) for r in range(world)]
    log(f"13b: {world} gloo ranks on one card ran in {time.perf_counter() - t0:.1f} s "
        f"(the gloo collectives go through the host: their rounds/sec above is not a speed "
        f"of the port)")
    for label in [t[0] for t in DP_TASKS] + ["12d replicated", "resume"]:
        if ranks[0][label].get("history") != ranks[1][label].get("history"):
            raise AssertionError(f"13b {label}: the ranks' host records differ")
        _held(f"13b {label} rank 1 vs rank 0", ranks[1][label]["params"],
              ranks[0][label]["params"])
    r0 = ranks[0]
    for label, _, rounds in DP_TASKS:
        log(f"13b {label}: bytes handed to gloo per round "
            f"{ {k: v // rounds for k, v in r0[label]['bytes'].items() if v} }")
    _held("13b 8a dp 2 vs 8a dp 1", r0["8a"]["params"], RESULTS["8a"]["params"], DP_PARAM_ATOL)
    _held("13b 12a dp 2 vs 12a dp 1", r0["12a"]["params"], RESULTS["12a"]["params"],
          DP_PARAM_ATOL)
    _held("13b 12d dp 2 vs 12d dp 1", r0["12d"]["params"], RESULTS["12d"]["params"],
          DP_PARAM_ATOL)
    _held("13b 12d sharded vs replicated at dp 2", r0["12d"]["params"],
          r0["12d replicated"]["params"])
    # The trimmed mean sorts every coordinate's client column whole on the
    # rank that owns it: bitwise dp 1, the quarantine decisions included.
    _held("13b 9b dp 2 vs 9b dp 1", r0["9b"]["params"], RESULTS["9b"]["params"])
    if r0["9b"]["quarantine"] != RESULTS["9b"]["quarantine"]:
        raise AssertionError("13b 9b: the quarantine state differs from dp 1's")
    if r0["resume"]["start"] != 2:
        raise AssertionError(f"13b resume: preempted after {r0['resume']['start']} rounds")
    _held("13b resume dp 2 vs 12a dp 2", r0["resume"]["params"], r0["12a"]["params"])
    gib = lambda v: "not measured (cpu)" if v is None else f"{v / 2**30:.4f} GiB"
    log(f"13b 9b peak device memory per rank: dp 1 {gib(RESULTS['9b']['peak'])}, dp 2 "
        + ", ".join(f"rank {r} {gib(res['9b']['peak'])}" for r, res in enumerate(ranks))
        + f" | {card}")
    log(f"phase 13 seconds: {time.perf_counter() - t_phase:.1f}")


# Phase 14: model parallelism. 14a runs fedadam_sent140_distilbert_mp2 with
# its clients cut to MP_CLIENTS and its block (64, which does not fit one
# card even at mp 1: A18) to MP_BLOCK.
MP_CLIENTS = (16,)
MP_BLOCK = 16
# 14c: a pipelined round of full-width DistilBERT (pp 2, M 2).
PP_CLIENTS, PP_BLOCK, PP_STEPS = 8, 4, 2
# 14d: ep_train_step of moe_text at registry defaults (8 experts) on a batch
# of EP_BATCH sequences.
EP_BATCH = 64
# 14a-14d against the same work at mp 1 (pp 1, ep 1) on the card: bf16
# products split in two and summed over the ranks round once more than the
# whole product, and bf16 activations round to the neighbouring value (2^-8
# relative); a wrong shard, hop or sum moves a step's update by O(1).
# Compared as in phase 7: what one round (step) moved, ||split - whole|| /
# ||whole||.
MP_MOVE_REL = CARD_CPU_REL
MP_TIMEOUT_S = 600


def _no_parallel_edit(task):
    params = _engine_params(task)
    old = params.pop("parallel")
    _set_engine_params(task, params)
    return f"parallel {old} -> none (the mp-1 reference)"


def _moved_rel(label, got, want, p0, limit):
    """How far ``got``'s move from ``p0`` is from ``want``'s, relative."""
    rel = _rel_l2({k: got[k].float() - p0[k].float() for k in p0},
                  {k: want[k].float() - p0[k].float() for k in p0})
    log(f"{label}: move relative L2 {rel:.3e} (limit {limit:g})")
    if not rel <= limit:
        raise AssertionError(f"{label}: the move differs from the reference's")


def _pp_setup(dev, plan, small):
    """14c's pipelined (or dense, at pp 1) FedAdam core of full-width
    DistilBERT and its clients, this rank's shard placed."""
    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        fedadam,
        make_synthetic_text_dataset,
    )

    cfg = FedCoreConfig(batch_size=16, max_local_steps=PP_STEPS, block_clients=PP_BLOCK)
    over = small.get("distilbert")
    ds = make_synthetic_text_dataset(0, PP_CLIENTS, 24, MAIN_SEQ_LEN, dirichlet_alpha=0.8,
                                     vocab_size=(over or {}).get("vocab_size", 30522))
    ds = ds.pad_for(plan.dp * cfg.block_clients).shard(plan).to(dev)
    core = build_fedcore("distilbert", fedadam(0.01, 0.001), cfg, model_overrides=over,
                         input_shape=(MAIN_SEQ_LEN,), device=dev, plan=plan,
                         microbatches=2 if plan.pp > 1 else None)
    return core, ds


def _ep_setup(dev, small):
    """14d's moe_text at registry defaults, its seed-0 params and a batch."""
    import numpy as np
    import torch

    from olearning_sim_tpu_torch.models import get_model

    model = get_model("moe_text").build(**small.get("moe_text", {})).to(dev)
    params = {k: v.to(dev) for k, v in model.init_params(
        torch.Generator().manual_seed(0)).items()}
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, model.embed.weight.shape[0], (EP_BATCH, MAIN_SEQ_LEN)).astype(
        np.int32)
    tokens[::3, MAIN_SEQ_LEN // 2:] = 0
    return model, params, tokens, (tokens[:, 0] % 2).astype(np.int64)


def _mp_rank(rank, world, store_path, out_dir, dev_type, shrink, small):
    """Phase 14 on one rank (a spawned process), over a gloo group of
    ``world`` ranks on card 0 (or the CPU in a rehearsal): 14a-14d; results
    as a torch file per rank. Rank 0 alone prints."""
    import contextlib
    import io
    import os

    import torch
    import torch.distributed as dist

    from olearning_sim_tpu_torch.engine.algorithms import SGD
    from olearning_sim_tpu_torch.ops import flash_attention
    from olearning_sim_tpu_torch.parallel import collectives
    from olearning_sim_tpu_torch.parallel import expert_parallel as ep_mod
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    dev = torch.device("cpu")
    if dev_type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    quiet = contextlib.redirect_stdout(io.StringIO()) if rank else contextlib.nullcontext()
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    out = {}
    try:
        with quiet:
            # 14a: the mp-2 config through the bridge.
            collectives.reset_bytes()
            t0 = time.perf_counter()
            runner, hist = run_task("14a mp 2", "fedadam_sent140_distilbert_mp2", dev, 1,
                                    clients=MP_CLIENTS, edit=block_edit(MP_BLOCK),
                                    shrink=shrink)
            if (runner.core.dp, runner.core.mp) != (1, 2):
                raise AssertionError(f"14a: the bridge's plan is dp {runner.core.dp} x mp "
                                     f"{runner.core.mp}, not 1 x 2")
            out["14a"] = {"params": _host(runner.states["data_0"].params),
                          "history": json.dumps(hist, sort_keys=True, default=float),
                          "peak": _peak(dev), "bytes": dict(collectives.BYTES),
                          "seconds": time.perf_counter() - t0,
                          "sharded": runner.core.tp_sharded_ratio}
            del runner
            # 14b: a flash evaluate at mp 2, K1 on every rank, of phase 5's
            # trained model; held by its logits against mp 1's.
            plan = make_mesh_plan(mp=2)
            core = _flash_core(dev, plan, small)
            ref = torch.load(os.path.join(out_dir, "14b.pt"), weights_only=False)
            fparams = {k: v.to(dev) for k, v in ref["params"].items()}
            x_eval, y_eval = _eval_set(small)
            collectives.reset_bytes()
            flash_attention.launches = 0
            _sync(dev)
            t0 = time.perf_counter()
            loss, acc = core.evaluate(fparams, x_eval, y_eval)
            _sync(dev)
            out["14b"] = {"loss": loss, "acc": acc, "launches": flash_attention.launches,
                          "seconds": time.perf_counter() - t0, "bytes": dict(collectives.BYTES),
                          "depth": len(core.model.blocks),
                          "batches": -(-len(y_eval) // core.config.eval_batch_size)}
            out["14b"]["moves"] = hold_k1_by_logits(
                f"14b rank {rank}", core, fparams, x_eval, ref["logits"], ref["card"],
                wrong_must_fail=ref["trained"])
            del core, fparams
            # 14c: a pipelined round.
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            plan = make_mesh_plan(pp=2)
            core, ds = _pp_setup(dev, plan, small)
            state = core.init_state(seed=0, device=dev)
            collectives.reset_bytes()
            _sync(dev)
            t0 = time.perf_counter()
            state, m = core.round_step(state, ds)
            _sync(dev)
            out["14c"] = {"params": _host(state.params), "loss": float(m.mean_loss),
                          "seconds": time.perf_counter() - t0, "bytes": dict(collectives.BYTES),
                          "peak": _peak(dev)}
            del core, ds, state, m
            # 14d: an expert-parallel step.
            plan = make_mesh_plan(ep=2)
            model, params, tokens, labels = _ep_setup(dev, small)
            mine, specs = ep_mod.ep_place_params(params, plan)
            opt = SGD(0.1)
            collectives.reset_bytes()
            _sync(dev)
            t0 = time.perf_counter()
            new, _, loss = ep_mod.ep_train_step(model, mine, opt.init(mine), tokens, labels,
                                                opt, plan)
            _sync(dev)
            out["14d"] = {"params": _host(new), "loss": loss,
                          "seconds": time.perf_counter() - t0, "bytes": dict(collectives.BYTES),
                          "split": sorted(k for k, d in specs.items() if d is not None)}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _eval_set(small):
    """14b's rows: phase 5's (narrowed by ``small`` in a rehearsal)."""
    return padded_eval_set(small.get("eval_n", 2048),
                           small.get("distilbert", {}).get("vocab_size", 30522))


def _flash_core(dev, plan, small):
    from olearning_sim_tpu_torch.engine import FedCoreConfig, build_fedcore, fedadam

    over = dict(small.get("distilbert", {}), attention_impl="flash")
    return build_fedcore("distilbert", fedadam(0.01, 0.001), FedCoreConfig(**MAIN_CFG),
                         model_overrides=over, input_shape=(MAIN_SEQ_LEN,), device=dev,
                         plan=plan)


def mp_path(dev, shrink=None, small=None):
    """Phase 14: model parallelism over two ranks on the one card, over gloo
    (NCCL refuses two ranks on one card), spawned as 13b. 14a runs
    ``fedadam_sent140_distilbert_mp2`` through the bridge, 14b a flash
    evaluate at mp 2 (K1 on every rank), 14c a pipelined round of
    full-width DistilBERT, 14d an expert-parallel step of moe_text; each
    against the same work at mp 1 (pp 1, ep 1) here on the card.
    ``shrink`` narrows 14a's task and ``small`` the others' models
    (``{"distilbert": overrides, "moe_text": overrides, "eval_n": n}``), for
    rehearsals on the CPU only."""
    import tempfile
    import zlib

    import torch
    import torch.multiprocessing as tmp
    import torch.nn.functional as F
    from torch.func import functional_call

    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from olearning_sim_tpu_torch.parallel.mesh import MeshPlan

    t_phase = time.perf_counter()
    card = card_line() if dev.type == "cuda" else "cpu"
    one = MeshPlan(dp=1, sp=1, rank=0)
    # The references at mp 1, on the card.
    task, _ = load_task("fedadam_sent140_distilbert_mp2", 1, clients=MP_CLIENTS,
                        edit=_edits(block_edit(MP_BLOCK), _no_parallel_edit), shrink=shrink)
    probe = build_runner_from_taskconfig(task, device="cpu")
    p0 = _host(probe.core.init_state(seed=zlib.crc32(probe.task_id.encode()) & 0x7FFFFFFF,
                                     device="cpu").params)
    del probe
    ref, _ = run_task("14a mp 1", "fedadam_sent140_distilbert_mp2", dev, 1,
                      clients=MP_CLIENTS, edit=_edits(block_edit(MP_BLOCK), _no_parallel_edit),
                      shrink=shrink)
    small = small or {}
    a_ref = {"params": _host(ref.states["data_0"].params), "peak": _peak(dev)}
    del ref
    # 14b's model: phase 5's trained one (a rehearsal that skipped phase 5
    # evaluates an untrained one, which wrong kernels need not fail).
    core = _flash_core(dev, one, small)
    x_eval, y_eval = _eval_set(small)
    trained = "5" in RESULTS
    bparams = ({k: v.to(dev) for k, v in RESULTS["5"]["flash"].items()} if trained
               else core.init_state(seed=0, device=dev).params)
    b_ref = core.evaluate(bparams, x_eval, y_eval)
    b_in = {"params": _host(bparams), "logits": eval_logits(core, bparams, x_eval).cpu(),
            "card": card, "trained": trained and dev.type == "cuda"}
    del bparams
    core, ds = _pp_setup(dev, one, small)
    state = core.init_state(seed=0, device=dev)
    c_p0 = _host(state.params)
    state, m = core.round_step(state, ds)
    c_ref = {"params": _host(state.params), "loss": float(m.mean_loss)}
    del core, ds, state, m
    model, params, tokens, labels = _ep_setup(dev, small)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    logits, aux = functional_call(model, leaves, (torch.as_tensor(tokens, device=dev).long(),),
                                  {"return_aux": True})
    ce = F.cross_entropy(logits.float(), torch.as_tensor(labels, device=dev))
    grads = torch.autograd.grad(ce + 0.01 * aux.float(), list(leaves.values()))
    d_ref = {"params": {k: (v - 0.1 * g).detach().cpu() for (k, v), g in
                        zip(leaves.items(), grads)}, "loss": float(ce.detach())}
    d_p0 = _host(params)
    del model, params, leaves, logits, aux, grads
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    world = 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_14_") as work:
        torch.save(b_in, f"{work}/14b.pt")
        del b_in
        t0 = time.perf_counter()
        ctx = tmp.start_processes(_mp_rank, args=(world, f"{work}/store", work, dev.type,
                                                  shrink, small),
                                  nprocs=world, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1):
                if time.perf_counter() - t0 > MP_TIMEOUT_S:
                    raise AssertionError(f"14: the ranks passed {MP_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
        ranks = [torch.load(f"{work}/rank{r}.pt", weights_only=False) for r in range(world)]
    log(f"14: {world} gloo ranks on one card ran in {time.perf_counter() - t0:.1f} s (the "
        f"collectives go through the host: no speed of the port is read from them)")
    r0 = ranks[0]
    if ranks[1]["14a"]["history"] != r0["14a"]["history"]:
        raise AssertionError("14a: the ranks' host records differ")
    for label in ("14a", "14c"):
        _held(f"{label} rank 1 vs rank 0", ranks[1][label]["params"], r0[label]["params"])
    _moved_rel("14a mp 2 vs mp 1", r0["14a"]["params"], a_ref["params"], p0, MP_MOVE_REL)
    gib = lambda v: "not measured (cpu)" if v is None else f"{v / 2**30:.4f} GiB"
    log(f"14a peak device memory per rank: mp 1 {gib(a_ref['peak'])}, mp 2 "
        + ", ".join(f"rank {r} {gib(res['14a']['peak'])}" for r, res in enumerate(ranks))
        + f" | {card}")
    log(f"14a: sharded fraction {r0['14a']['sharded']:.6f}; {r0['14a']['seconds']:.1f} s; "
        f"bytes handed to gloo per round { {k: v for k, v in r0['14a']['bytes'].items() if v} }"
        f" (rounds/sec {1.0 / r0['14a']['seconds']:.4f} through the host: not a speed of "
        f"the port) | {card}")
    for r, res in enumerate(ranks):
        b = res["14b"]
        want = b["depth"] * b["batches"]
        log(f"14b rank {r}: flash evaluate at mp 2 loss={b['loss']:.6f} acc={b['acc']:.4f} "
            f"(mp 1: {b_ref[0]:.6f} / {b_ref[1]:.4f}), K1 launches {b['launches']} "
            f"(expected {want}), {b['seconds']:.2f} s, bytes { {k: v for k, v in b['bytes'].items() if v} }")
        if dev.type == "cuda" and b["launches"] != want:
            raise AssertionError(f"14b rank {r}: K1 launched {b['launches']} times")
        if not abs(b["loss"] - b_ref[0]) <= EVAL_LOSS_TOL:
            raise AssertionError(f"14b rank {r}: the mp-2 loss differs from mp 1's")
        log(f"14b rank {r}: wrong kernels move the mp-2 logits by "
            + ", ".join(f"{w} {m:.3e} ({m / EVAL_LOGITS_ATOL:.1f}x the tolerance)"
                        for w, m in b["moves"].items()) + f" | {card}")
    c = r0["14c"]
    log(f"14c pp 2: mean_loss={c['loss']:.6f} (pp 1 {c_ref['loss']:.6f}), {c['seconds']:.1f} s, "
        f"peak {gib(c['peak'])}, bytes { {k: v for k, v in c['bytes'].items() if v} }")
    _moved_rel("14c pp 2 vs pp 1", c["params"], c_ref["params"], c_p0, MP_MOVE_REL)
    d = {k: (torch.cat([res["14d"]["params"][k] for res in ranks]) if k in r0["14d"]["split"]
             else r0["14d"]["params"][k]) for k in d_p0}
    log(f"14d ep 2: {len(r0['14d']['split'])} expert leaves split; loss={r0['14d']['loss']:.6f} "
        f"(dense {d_ref['loss']:.6f}), {r0['14d']['seconds']:.2f} s, bytes "
        f"{ {k: v for k, v in r0['14d']['bytes'].items() if v} }")
    _moved_rel("14d ep 2 vs dense", d, d_ref["params"], d_p0, MP_MOVE_REL)
    log(f"phase 14 seconds: {time.perf_counter() - t_phase:.1f}")


CONTROL_TASKS = (("fedadam_sent140_distilbert", 2, 9), ("fedavg_mnist_mlp", 3, 1))
CONTROL_RESUME_ROUNDS = 6
CONTROL_DIE_AFTER = 2


def priority_edit(priority):
    """An ``edit`` that sets the task's priority."""
    def edit(task):
        old = task["target"].get("priority", 0)
        task["target"]["priority"] = priority
        return f"priority {old} -> {priority}"
    return edit


def _control_task(name, rounds, priority, shrink):
    big = name == "fedadam_sent140_distilbert" and shrink is None
    return load_task(name, rounds, clients=[64] if big else None,
                     edit=_edits(block_edit(DISTILBERT_BLOCK) if big else None,
                                 priority_edit(priority)),
                     shrink=shrink)


def _perf_rates(perf, task_id):
    """Rounds/sec from a performance manager's rows: over all rounds, and
    after the first (the median of the later rounds' summed operator
    times)."""
    import statistics

    by_round = {}
    for t in perf._timings.get(task_id, []):
        by_round[t.round_idx] = by_round.get(t.round_idx, 0.0) + t.duration_s
    steady = [by_round[r] for r in sorted(by_round)[1:]]
    return (perf.get_performance(task_id)["rounds_per_sec"],
            1.0 / statistics.median(steady) if steady else float("nan"))


def control_path(dev, shrink=None):
    """Phase 15: the port's control plane drives port runners on the card."""
    import os
    import tempfile
    import threading
    import urllib.request

    import torch

    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from olearning_sim_tpu_torch.performancemgr import PerformanceManager
    from olearning_sim_tpu_torch.resilience import ResilienceLog
    from olearning_sim_tpu_torch.resourcemgr import DeviceTopology, ResourceManager
    from olearning_sim_tpu_torch.supervisor import TaskSupervisor
    from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig
    from olearning_sim_tpu_torch.taskmgr.queue_repo import SqliteQueueRepo
    from olearning_sim_tpu_torch.taskmgr.scheduler import get_task_request_resource
    from olearning_sim_tpu_torch.taskmgr.status import TaskStatus
    from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo
    from olearning_sim_tpu_torch.telemetry import (
        MetricsHTTPServer,
        MetricsRegistry,
        render_prometheus,
        set_default_registry,
    )

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_15_")
    registry = MetricsRegistry()
    previous = set_default_registry(registry)
    card = card_line() if dev.type == "cuda" else "cpu"

    def same(label, a, b):
        diff = max(float((a[k] - b[k]).abs().max()) for k in b)
        log(f"{label}: params max abs diff {diff:g} (tol 0)")
        if diff != 0 or not all(bool(torch.equal(a[k], b[k])) for k in b):
            raise AssertionError(f"{label}: not bitwise equal")

    # 15a: two tasks through one manager.
    tasks = {}  # task id -> (config name, task JSON, rounds)
    for name, rounds, priority in CONTROL_TASKS:
        task, cuts = _control_task(name, rounds, priority, shrink)
        tasks[task["task_id"]] = (name, task, rounds)
        log(f"15a {name} (task {task['task_id']}): " + "; ".join(cuts))
    requests = {t: get_task_request_resource(json2taskconfig(task))["logical_simulation"]
                for t, (_, task, _) in tasks.items()}
    largest = max(max(r["cpu"], r["mem"]) for r in requests.values())
    units = sum(max(r["cpu"], r["mem"]) for r in requests.values())
    log(f"15a units per card U={units:g}: the scheduler admits a task whose "
        f"num_cpus x num_request units are free, and these ask for "
        f"{ {t: r['cpu'] for t, r in requests.items()} }; at one unit per card the "
        f"largest request ({largest:g}) would never be admitted, so U is at least that, "
        f"and at the sum of the requests both tasks run at once")
    repo = TaskTableRepo(sqlite_path=os.path.join(tmp.name, "tasks.db"))
    intake = SqliteQueueRepo(os.path.join(tmp.name, "intake.db"))
    topo = DeviceTopology.detect(dev, units_per_core=units, mem_per_core=units)
    rm = ResourceManager(topology=topo)
    perf = PerformanceManager()
    mgr = TaskManager(task_repo=repo, resource_manager=rm, perf=perf, intake_queue=intake,
                      schedule_interval=3600, device=dev)
    log(f"15a topology: {topo}")
    want = sorted(tasks, key=lambda t: -tasks[t][1]["target"]["priority"])
    for t in reversed(want):  # the lower priority first on the intake
        intake.push(json.dumps(tasks[t][1]))
    t_submit = time.perf_counter()
    if mgr.drain_intake_once() != 2:
        raise AssertionError("15a: the intake did not yield both tasks")
    order, launched = [], {}
    while len(order) < len(tasks):
        task_id = mgr.schedule_once()
        if task_id is None:
            raise AssertionError(f"15a: scheduling stalled after {order}; "
                                 f"free {rm.get_resource()['logical_simulation']}")
        order.append(task_id)
        launched[task_id] = time.perf_counter()
    log(f"15a scheduled {order} (intake order {list(reversed(want))}, by priority {want}); "
        f"free after both {rm.get_resource()['logical_simulation']}")
    if order != want:
        raise AssertionError("15a: the scheduling order does not follow priority")
    ended, jobs = {}, {t: mgr._launcher.get_job(repo.get_item_value(t, "job_id"))
                        for t in order}
    while len(ended) < len(jobs):
        for t, job in jobs.items():
            if t not in ended and job.status not in (TaskStatus.PENDING, TaskStatus.RUNNING):
                ended[t] = time.perf_counter()
        time.sleep(0.02)
    for t, job in jobs.items():
        if job.status != TaskStatus.SUCCEEDED:
            raise AssertionError(f"15a {t}: job {job.status.name}: {job.error}")

    # 15b: the exporters, before the release retires the tasks' series.
    text = perf.render_metrics()
    for t, (_, _, rounds) in tasks.items():
        series = registry.get("ols_engine_round_phase_duration_seconds")
        counts = {key[1:]: child.count for key, child in series.children() if key[0] == t}
        log(f"15b {t}: ols_engine_round_phase_duration_seconds (operator, phase) counts "
            f"{counts}")
        if counts.get(("train", "train")) != rounds or \
                f'ols_engine_round_phase_duration_seconds_count{{task_id="{t}"' not in text:
            raise AssertionError(f"15b {t}: the render lacks the task's round-phase series")
    taskmgr_lines = [ln for ln in text.splitlines()
                     if ln.startswith("ols_taskmgr_") and not ln.startswith("ols_taskmgr_task_wait_seconds_bucket")]
    log("15b ols_taskmgr_* series: " + "; ".join(taskmgr_lines))
    for name in ("ols_taskmgr_queue_depth", "ols_taskmgr_state_transitions_total",
                 "ols_taskmgr_task_wait_seconds_count"):
        if not any(ln.startswith(name) for ln in taskmgr_lines):
            raise AssertionError(f"15b: the render lacks {name}")
    with MetricsHTTPServer(host="127.0.0.1", port=0) as srv:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=30) as r:
            scraped = r.read().decode()
        rendered = render_prometheus()
    log(f"15b scrape of 127.0.0.1:{srv.port}/metrics: {len(scraped)} bytes, "
        f"{len(scraped.splitlines())} lines, equal to the render: {scraped == rendered}")
    if scraped != rendered:
        raise AssertionError("15b: the scrape differs from the render")

    mgr.release_once()
    for t in order:
        status, rnd = repo.get_item_value(t, "task_status"), repo.get_item_value(t, "logical_round")
        rounds = tasks[t][2]
        direct_perf = PerformanceManager(registry=MetricsRegistry())
        direct = build_runner_from_taskconfig(tasks[t][1], perf=direct_perf,
                                              registry=MetricsRegistry(), device=dev)
        direct.run()
        wait = launched[t] - t_submit
        all_m, steady_m = _perf_rates(perf, t)
        all_d, steady_d = _perf_rates(direct_perf, t)
        log(f"15a {t}: {status}, logical_round {rnd}; queue wait {wait:.4f} s, launch to end "
            f"{ended[t] - launched[t]:.3f} s; runner rounds/sec through the manager "
            f"{all_m:.4f} (after the first {steady_m:.4f}), direct {all_d:.4f} (after the "
            f"first {steady_d:.4f}) | {card}")
        if status != TaskStatus.SUCCEEDED.name or int(rnd) != rounds:
            raise AssertionError(f"15a {t}: row {status}, logical_round {rnd}")
        same(f"15a {t} through the manager vs direct", jobs[t].runner.states["data_0"].params,
             direct.states["data_0"].params)
        del direct
    waits = dict(registry.get("ols_taskmgr_task_wait_seconds").children())[()]
    log(f"15a ols_taskmgr_task_wait_seconds: count {waits.count}, sum {waits.sum:.4f} s")
    del jobs
    mgr.stop()

    # 15b: the profiler around one round.
    trace_dir = os.path.join(tmp.name, "trace")
    task, _ = load_task("fedavg_mnist_mlp", 2, shrink=shrink)
    task["task_id"] += "_traced"
    tperf = PerformanceManager()
    runner = build_runner_from_taskconfig(task, perf=tperf, device=dev)
    runner.begin()
    runner.step()
    if torch.autograd._profiler_enabled():
        raise AssertionError("15b: a torch.profiler session is already open")
    _sync(dev)
    if not tperf.start_trace(trace_dir):
        raise AssertionError("15b: start_trace refused")
    runner.step()
    _sync(dev)
    out = tperf.stop_trace()
    runner.finish()
    with open(os.path.join(out, PerformanceManager.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    with open(os.path.join(out, PerformanceManager.RUNNER_SPAN_FILE)) as f:
        spans = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    log(f"15b torch.profiler around round 1: {len(events)} events, {len(kernels)} CUDA "
        f"kernel events ({sum(e.get('dur', 0) for e in kernels):.1f} us), trace "
        f"{os.path.getsize(os.path.join(out, PerformanceManager.TRACE_FILE))} bytes; "
        f"runner spans {sorted({e['name'] for e in spans})}")
    if (dev.type == "cuda" and not kernels) or not any(e["name"] == "round.train" for e in spans):
        raise AssertionError("15b: the trace lacks CUDA kernel events or the runner spans")

    # 15c: the supervisor reclaims and resumes a task whose owner died.
    db = os.path.join(tmp.name, "resume.db")
    ckpt = {"directory": os.path.join(tmp.name, "ckpt", "{task_id}"), "every": 1}
    task, cuts = load_task("fedavg_mnist_mlp", CONTROL_RESUME_ROUNDS, shrink=shrink,
                           edit=params_edit(checkpoint=ckpt))
    task["task_id"] += "_supervised"
    log(f"15c {task['task_id']}: " + "; ".join(cuts))
    plain = json.loads(json.dumps(task))
    params = _engine_params(plain)
    params.pop("checkpoint")
    _set_engine_params(plain, params)
    straight = build_runner_from_taskconfig(plain, registry=MetricsRegistry(), device=dev)
    straight.run()
    owner_repo = TaskTableRepo(sqlite_path=db)
    died = threading.Event()

    def dying_runner(tc, stop_event):
        runner = build_runner_from_taskconfig(tc, task_repo=owner_repo, stop_event=stop_event,
                                              device=dev)
        step, done = runner.step, []

        def step_then_die():
            more = step()
            done.append(1)
            if len(done) == CONTROL_DIE_AFTER:
                runner.checkpointer.wait()
                died.set()
                raise RuntimeError("the owner process died")
            return more
        runner.step = step_then_die
        return runner

    owner = TaskManager(task_repo=owner_repo, schedule_interval=3600, supervise_orphans=True,
                        runner_factory=dying_runner, device=dev)
    if not owner.submit_task(task) or owner.schedule_once() != task["task_id"]:
        raise AssertionError("15c: the task did not launch")
    owner._launcher.get_job(f"job-{task['task_id']}").join()
    owner.stop()  # the dead manager: no release, no heartbeat
    if not died.is_set():
        raise AssertionError("15c: the owner's runner did not reach its death")
    sup_repo = TaskTableRepo(sqlite_path=db)
    _, expires = sup_repo.lease_info(task["task_id"])
    row = {k: sup_repo.get_item_value(task["task_id"], k)
           for k in ("task_status", "resource_occupied", "logical_round")}
    log(f"15c after the owner died: row {row}, lease expires at {expires:.3f}")
    sup = TaskSupervisor(task_repo=sup_repo, backoff_base_s=0.0, log=ResilienceLog(),
                         device=dev)
    if sup.scan_once(now=expires - 1.0)["resumed"]:
        raise AssertionError("15c: a live lease was reclaimed")
    t_reclaim = time.perf_counter()
    digest = sup.scan_once(now=expires + 1.0)
    if digest["resumed"] != [task["task_id"]]:
        raise AssertionError(f"15c: the supervisor did not resume the task: {digest}")
    first = None
    job = sup.launcher.get_job(sup_repo.get_item_value(task["task_id"], "job_id"))
    while job.status in (TaskStatus.PENDING, TaskStatus.RUNNING):
        if first is None and int(sup_repo.get_item_value(task["task_id"], "logical_round")
                                 or 0) > CONTROL_DIE_AFTER:
            first = time.perf_counter() - t_reclaim
        time.sleep(0.01)
    if job.status != TaskStatus.SUCCEEDED:
        raise AssertionError(f"15c: resumed job {job.status.name}: {job.error}")
    if first is None:
        first = float("nan")
    digest = sup.scan_once(now=expires + 2.0)
    resumes = registry.get("ols_supervisor_resumes_total").labels(task_id=task["task_id"]).value
    status = sup_repo.get_item_value(task["task_id"], "task_status")
    log(f"15c reclaimed and resumed: {first:.3f} s from the reclaim to the first resumed "
        f"round; rounds run by the resumed job "
        f"{[h['round'] for h in job.runner.history[CONTROL_DIE_AFTER:]]}; finalized "
        f"{digest['finalized']}, row {status}; ols_supervisor_resumes_total {resumes:g} | {card}")
    if digest["finalized"] != [task["task_id"]] or status != TaskStatus.SUCCEEDED.name \
            or resumes != 1:
        raise AssertionError("15c: the resumed task was not finalized once as SUCCEEDED")
    same("15c supervised resume vs uninterrupted", job.runner.states["data_0"].params,
         straight.states["data_0"].params)
    set_default_registry(previous)
    tmp.cleanup()
    log(f"phase 15 seconds: {time.perf_counter() - t_phase:.1f}")


PLATFORM_ROUNDS = 3
PLATFORM_FLOW = {"flow_dispatch": {"use_strategy": True, "total_dispatch_amount": 20,
                                   "specific_timing": {"use": True, "time_type": "relative",
                                                       "timings": [0], "amounts": [20]}}}
PLATFORM_BOOT_S = 240
PLATFORM_TASK_S = 600
MIGRATE_ROUNDS = 6
MIGRATE_AFTER = 2
FLOW_MESSAGES = 1000
FLOW_BATCH = 50
FLOW_DROP = 0.1
FLOW_SEED = 7


def flow_edit(strategy):
    """An ``edit`` that turns the train operator's behaviour controller on
    with ``strategy``."""
    def edit(task):
        ctl = task["operatorflow"]["operators"][0]["operation_behavior_controller"]
        ctl.update(use_gradient_house=True, strategy_gradient_house=json.dumps(strategy))
        return f"behaviour controller on: {json.dumps(strategy)}"
    return edit


def _wait(cond, timeout, what, poll=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(poll)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


class _FenceRunner:
    """A port runner driven round by round (what ``run()`` is). The task's
    first launch holds after MIGRATE_AFTER rounds until the fence's stop
    request arrives, so the migration lands at that round boundary; a
    relaunch stamps the end of its first round."""

    def __init__(self, inner, stop_event, held, first_launch):
        self.inner, self.stop_event, self.held = inner, stop_event, held
        self.first_launch = first_launch
        self.first_round_at = None

    @property
    def stopped(self):
        return self.inner.stopped

    def run(self):
        self.inner.begin()
        done = 0
        while True:
            more = self.inner.step()
            done += 1
            if self.first_round_at is None:
                self.first_round_at = time.perf_counter()
            if not more:
                break
            if self.first_launch and done == MIGRATE_AFTER:
                self.held.set()
                if not self.stop_event.wait(PLATFORM_TASK_S):
                    raise AssertionError("16b: the fence's stop request never came")
        return self.inner.finish()


def _flow_run(rooms_path, strategy):
    """FLOW_MESSAGES messages through the port's DeviceFlowService (durable
    rooms when ``rooms_path`` is given): the delivered batches and the
    messages per second from the first publish to the flow's end."""
    from olearning_sim_tpu_torch.deviceflow import DeviceFlowService

    batches = []

    def factory(flow_id, cfg):
        return lambda batch: batches.append(list(batch))

    svc = DeviceFlowService(poll_interval=0.005, seed=FLOW_SEED, rooms_path=rooms_path,
                            outbound_factory=factory)
    svc.register_task("df", ["logical_simulation"])
    svc.start()
    ok, msg = svc.notify_start("df", "df_train_0", "logical_simulation", strategy)
    if not ok:
        raise AssertionError(f"16c: notify_start refused: {msg}")
    t0 = time.perf_counter()
    for i in range(FLOW_MESSAGES):
        svc.publish("df_train_0", "logical_simulation", {"client": i, "update": [i, -i]})
    ok, msg = svc.notify_complete("df", "df_train_0", "logical_simulation")
    if not ok:
        raise AssertionError(f"16c: notify_complete refused: {msg}")
    _wait(lambda: svc.check_dispatch_finished("df"), 120, "16c: the flow to finish")
    seconds = time.perf_counter() - t0
    svc.stop()
    if rooms_path is not None:
        svc.inbound.close()
        svc.shelf_room.close()
    return batches, FLOW_MESSAGES / seconds


def platform_path(dev, shrink=None):
    """Phase 16: the platform booted from a config file, the chip-pool
    scheduler and the deviceflow service, the port's own."""
    import os
    import signal
    import tempfile
    import threading
    import zlib

    import numpy as np
    import torch

    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from olearning_sim_tpu_torch.deviceflow import DeviceFlowService
    from olearning_sim_tpu_torch.resilience import ResilienceLog
    from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig
    from olearning_sim_tpu_torch.performancemgr.hbm_budget import (measure_hbm_budget,
                                                                   tensor_bytes)
    from olearning_sim_tpu_torch.taskmgr.pool import (ChipPool, CostOracle, MeshSpec,
                                                      PoolScheduler)
    from olearning_sim_tpu_torch.taskmgr.queue_repo import SqliteQueueRepo
    from olearning_sim_tpu_torch.taskmgr.status import TaskStatus
    from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo
    from olearning_sim_tpu_torch.telemetry import MetricsRegistry
    from olearning_sim_tpu_torch.utils.repo import SqliteTableRepo

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_16_")
    card = card_line() if dev.type == "cuda" else "cpu"

    # 16a: python -m olearning_sim_tpu_torch --config platform.ini.
    db = os.path.join(tmp.name, "state.db")
    intake = os.path.join(tmp.name, "intake.db")
    ini = os.path.join(tmp.name, "platform.ini")
    with open(ini, "w") as f:
        f.write("[session]\nservices = taskmgr, resourcemgr, deviceflow, phonemgr, slicemgr, "
                "performancemgr\n\n[taskmgr]\nscheduler_sleep_time = 0.02\n"
                f"release_sleep_time = 0.02\n\n[repos]\nsqlite_path = {db}\n"
                f"intake_queue_path = {intake}\n\n[deviceflow]\npoll_interval = 0.01\n")
    style = "{task_id}_{round}_result_model.msgpack"
    models = {k: os.path.join(tmp.name, f"models_{k}") for k in ("platform", "direct")}
    task, cuts = load_task("fedavg_mnist_mlp", PLATFORM_ROUNDS, shrink=shrink, edit=_edits(
        flow_edit(PLATFORM_FLOW), model_edit(models["platform"], model_update_style=style)))
    task["task_id"] += "_platform"
    tid = task["task_id"]
    log(f"16a {tid}: " + "; ".join(cuts))
    cmd = [sys.executable, "-m", "olearning_sim_tpu_torch", "--config", ini]
    if dev.type != "cuda":
        cmd += ["--device", dev.type]
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # The child's output goes to a file: a pipe nobody drains would stall it.
    out_path = os.path.join(tmp.name, "platform.log")
    out = open(out_path, "w")
    t_boot = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=out, stderr=subprocess.STDOUT)

    def child_log():
        with open(out_path) as f:
            return f.read()

    def booted():
        if proc.poll() is not None:
            raise AssertionError(f"16a: the platform exited {proc.returncode}: {child_log()}")
        return next((ln for ln in child_log().splitlines() if "platform running" in ln), None)

    try:
        line = _wait(booted, PLATFORM_BOOT_S, "16a: the platform to boot")
        boot = time.perf_counter() - t_boot
        log(f"16a {' '.join(cmd[1:])}: {line.strip()!r} after {boot:.3f} s")
        repo = TaskTableRepo(sqlite_path=db)
        registry = SqliteTableRepo(db, "deviceflow_registry", ["task_id", "registry"])
        flows = SqliteTableRepo(db, "deviceflow_flow", ["task_id", "flow_id", "flow"])
        t_submit = time.perf_counter()
        SqliteQueueRepo(intake).push(json.dumps(task))
        seen, marks = {"registered": False}, {}

        def progressed():
            if proc.poll() is not None:
                raise AssertionError(f"16a: the platform exited {proc.returncode}: "
                                     f"{child_log()}")
            status = repo.get_item_value(tid, "task_status")
            if registry.get_values_by_conditions("task_id", task_id=tid):
                seen["registered"] = True
            if status and status not in ("UNDONE", "QUEUED") and "launch" not in marks:
                marks["launch"] = time.perf_counter() - t_submit
            if status in ("SUCCEEDED", "FAILED", "STOPPED") and \
                    str(repo.get_item_value(tid, "resource_occupied")) == "0":
                marks["end"] = time.perf_counter() - t_submit
                return status
            return None

        status = _wait(progressed, PLATFORM_TASK_S, "16a: the task to finish")
        row = {k: repo.get_item_value(tid, k) for k in ("task_status", "logical_round",
                                                         "logical_result", "job_error")}
        released = not registry.get_values_by_conditions("task_id", task_id=tid) and \
            not flows.get_values_by_conditions("flow_id", task_id=tid)
        log(f"16a {tid}: {status}, logical_round {row['logical_round']}; boot {boot:.3f} s, "
            f"submit to launch {marks.get('launch', float('nan')):.3f} s, submit to end "
            f"{marks['end']:.3f} s; deviceflow registration seen while running "
            f"{seen['registered']}, gone with its flows after the release {released} | {card}")
        if status != TaskStatus.SUCCEEDED.name or int(row["logical_round"]) != PLATFORM_ROUNDS:
            raise AssertionError(f"16a: row {row}")
        if not (seen["registered"] and released):
            raise AssertionError("16a: the release did not wait for check_dispatch_finished "
                                 "(the task's deviceflow registration was not held, or not "
                                 "dropped, around it)")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
    log(f"16a SIGTERM: exit {rc}")
    if rc != 0:
        raise AssertionError(f"16a: the platform exited {rc} on SIGTERM")
    svc = DeviceFlowService(poll_interval=0.01)
    svc.start()
    svc.register_task(tid, ["logical_simulation"])
    # The direct run exports into a directory of its own: one holding the
    # platform's files would be resumed from.
    direct_task = json.loads(json.dumps(task))
    params_edit(storage={"root": models["direct"]})(direct_task)
    direct = build_runner_from_taskconfig(direct_task, deviceflow=svc,
                                          registry=MetricsRegistry(), device=dev)
    direct.run()
    _wait(lambda: svc.check_dispatch_finished(tid), 60, "16a: the direct run's flows")
    svc.stop()
    want = direct.task_repo.get_item_value(tid, "logical_result")
    log(f"16a logical_result {row['logical_result']}; the direct run's equal: "
        f"{row['logical_result'] == want}")
    if row["logical_result"] != want:
        raise AssertionError(f"16a: logical_result differs from the direct run's {want}")
    last = style.format(task_id=tid, round=PLATFORM_ROUNDS - 1)
    files = {k: pathlib.Path(d, last).read_bytes() for k, d in models.items()}
    log(f"16a last model file {last}: platform {len(files['platform'])} bytes, the direct "
        f"run's byte for byte equal: {files['platform'] == files['direct']} (tol 0)")
    if files["platform"] != files["direct"]:
        raise AssertionError("16a: the platform's last model file differs from the direct run's")
    del direct

    # 16b: the chip-pool scheduler on the card.
    budgets = os.path.join(tmp.name, "hbm_budgets.json")
    m_task, _ = load_task("fedavg_mnist_mlp", 1, shrink=shrink)
    probe = build_runner_from_taskconfig(m_task, registry=MetricsRegistry(), device=dev)
    probe.begin()
    pop = probe.populations[0]
    if dev.type == "cuda":
        entry = measure_hbm_budget(probe.core, probe.states[pop.name], pop.dataset, budgets)
    else:  # the CPU rehearsal has no card to measure: the tensors' sizes stand in
        entry = {"params_bytes": tensor_bytes(probe.states[pop.name].params),
                 "largest_buffer_bytes": tensor_bytes(pop.dataset),
                 "clients": probe.core.config.block_clients}
        with open(budgets, "w") as f:
            json.dump({"plain/shard0/dp1": entry}, f)
    clients, family = pop.dataset.num_clients, _engine_params(m_task)["model"]["name"]
    del probe, pop
    log(f"16b budget from one {family} round on {clients} clients (padded): {entry}")
    oracle = CostOracle(budgets_path=budgets)
    # The card's memory; the CPU rehearsal, which has none, gives each worker
    # twice the task's estimate instead.
    total = (torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda"
             else 4 * oracle.estimate(json2taskconfig(m_task)).peak_hbm_bytes)
    rlog = ResilienceLog()
    workers = [MeshSpec(f"{dev}/half{i}", hbm_bytes=total / 2) for i in range(2)]
    sched = PoolScheduler(ChipPool(workers), oracle, log=rlog)
    mrepo = TaskTableRepo(sqlite_path=os.path.join(tmp.name, "pool.db"))
    held, launches = threading.Event(), []

    def factory(tc, stop_event):
        inner = build_runner_from_taskconfig(tc, task_repo=mrepo, stop_event=stop_event,
                                             registry=MetricsRegistry(), device=dev)
        launches.append(_FenceRunner(inner, stop_event, held, first_launch=not launches))
        return launches[-1]

    mgr = TaskManager(task_repo=mrepo, pool=sched, runner_factory=factory,
                      schedule_interval=3600, device=dev)
    log(f"16b pool: {[(w.name, w.hbm_bytes) for w in workers]} | {card}")
    big, _ = load_task("fedavg_mnist_mlp", 1, shrink=shrink,
                       edit=params_edit(scheduling={"peak_hbm_bytes": 2 * total}))
    big["task_id"] += "_oversized"
    admitted = mgr.submit_task(big)
    rejected = [(e.kind, e.detail.get("reason")) for e in rlog.events(task_id=big["task_id"])]
    log(f"16b {big['task_id']} (peak_hbm_bytes {2 * total}): admitted {admitted}, row "
        f"{mrepo.get_item_value(big['task_id'], 'task_status')}, events {rejected}")
    if admitted or rejected != [("admission_rejected", "oom")] or \
            mrepo.get_item_value(big["task_id"], "task_status") != "FAILED" or \
            mgr._launcher.get_job(f"job-{big['task_id']}") is not None:
        raise AssertionError("16b: the oversized task was not refused at submit")
    ckpt = {"directory": os.path.join(tmp.name, "ckpt", "{task_id}"), "every": 1}
    task, cuts = load_task("fedavg_mnist_mlp", MIGRATE_ROUNDS, shrink=shrink,
                           edit=params_edit(checkpoint=ckpt))
    task["task_id"] += "_migrated"
    tid = task["task_id"]
    plain = json.loads(json.dumps(task))
    params = _engine_params(plain)
    params.pop("checkpoint")
    _set_engine_params(plain, params)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    straight = build_runner_from_taskconfig(plain, registry=MetricsRegistry(), device=dev)
    straight.run()
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base if dev.type == "cuda" else float("nan")
    est = oracle.estimate(json2taskconfig(task))
    log(f"16b {tid}: " + "; ".join(cuts) + f"; oracle estimate {est.peak_hbm_bytes:.0f} B "
        f"({est.source}), the task's measured peak {peak:.0f} B above the {base} B already "
        f"held | {card}")
    if est.source != "static_hbm" or (dev.type == "cuda" and not est.peak_hbm_bytes >= peak):
        raise AssertionError(f"16b: the oracle's {est.source} estimate {est.peak_hbm_bytes} B "
                             f"is below the task's measured peak {peak} B")
    if not mgr.submit_task(task) or mgr.schedule_once() != tid:
        raise AssertionError("16b: the task was not admitted and launched")
    src = mrepo.get_item_value(tid, "worker_id")
    dst = next(w.name for w in workers if w.name != src)
    if not held.wait(PLATFORM_TASK_S):
        raise AssertionError("16b: the task did not reach its migration point")
    t_fence = time.perf_counter()
    outcome = sched.migrate(tid, dst, reason="chip_smoke")
    new_job = mgr._launcher.get_job(mrepo.get_item_value(tid, "job_id"))
    new_job.join(PLATFORM_TASK_S)
    fence = launches[-1].first_round_at - t_fence if len(launches) == 2 else float("nan")
    mgr.release_once()
    sup = json.loads(mrepo.get_item_value(tid, "supervision") or "{}")
    ev = [(e.kind, e.detail.get("worker", e.detail.get("dst"))) for e in rlog.events(task_id=tid)]
    status = mrepo.get_item_value(tid, "task_status")
    log(f"16b {tid}: migrate -> {outcome} ({src} -> {dst}, job {new_job.job_id}), fence "
        f"{fence:.3f} s from the stop to the first resumed round, {status}, resumes "
        f"{sup.get('resumes')}, events {ev}, worker_id {mrepo.get_item_value(tid, 'worker_id')}"
        f" | {card}")
    if outcome != "migrated" or status != TaskStatus.SUCCEEDED.name or sup.get("resumes") != 1 \
            or [k for k, _ in ev] != ["task_preempted", "task_migrated"] or \
            sched.pool.placement(tid) is not None or len(launches) != 2:
        raise AssertionError("16b: the migration did not finish as one resumed SUCCEEDED run")
    got, ref = new_job.runner.inner.states["data_0"].params, straight.states["data_0"].params
    diff = max(float((got[k] - ref[k]).abs().max()) for k in ref)
    log(f"16b migrated vs uninterrupted: params max abs diff {diff:g} (tol 0)")
    if diff != 0 or not all(bool(torch.equal(got[k], ref[k])) for k in ref):
        raise AssertionError("16b: the migrated run is not bitwise its uninterrupted run")
    mgr.stop()
    del straight, new_job, launches

    # 16c: the deviceflow service over durable SQLite rooms.
    strategy = json.dumps({"real_time_dispatch": {
        "use_strategy": True, "dispatch_batch_sizes": [FLOW_BATCH],
        "drop_simulation": {"drop_probability": FLOW_DROP}}})
    durable, rate = _flow_run(os.path.join(tmp.name, "rooms.db"), strategy)
    memory, mem_rate = _flow_run(None, strategy)
    rng = np.random.default_rng([FLOW_SEED, zlib.crc32(b"df_train_0")])
    oracle_kept = [i for i in range(FLOW_MESSAGES) if not rng.random() < FLOW_DROP]
    kept = [m["client"] for b in durable for m in b]
    log(f"16c {FLOW_MESSAGES} messages, real-time batches of {FLOW_BATCH}, drop probability "
        f"{FLOW_DROP}, seed {FLOW_SEED}: durable rooms delivered {len(kept)} in {len(durable)} "
        f"batches at {rate:.1f} messages/s, in-memory rooms {sum(map(len, memory))} at "
        f"{mem_rate:.1f} messages/s; equal to each other {durable == memory}, to the numpy "
        f"oracle {kept == oracle_kept} | {card}")
    if durable != memory or kept != oracle_kept:
        raise AssertionError("16c: the durable rooms' deliveries differ")
    tmp.cleanup()
    log(f"phase 16 seconds: {time.perf_counter() - t_phase:.1f}")


# Phase 17: task inputs from outside. Every archive is written here from
# INGEST_SEED in its published layout; the sizes are module constants so a
# CPU rehearsal can cut them.
INGEST_SEED = 15
INGEST_ROUNDS = 2
SENT140_ROWS = 160_000       # the training CSV's 1,600,000 rows, cut 10x
SENT140_USERS = 16_000       # about 10 tweets per user, as in the full file
SENT140_TEST_ROWS = 2_048    # fedadam_sent140_distilbert's eval_n
SENT140_REAL = {"scheme": "by_writer", "n_local": 24}
# 17a's witness: the task at a lower local learning rate, trained until its
# eval accuracy is far above chance (0.5; one standard deviation of a
# coin's accuracy over 2,048 rows is 0.011).
WITNESS_LOCAL_LR = 1e-3
WITNESS_ROUNDS = 8
WITNESS_ACC = 0.6
MNIST_ROWS = (60_000, 10_000)  # train, t10k: the published counts
MNIST_REAL = {"scheme": "dirichlet", "alpha": 0.5}
HYBRID_ALLOCATION = (75, 25)   # logical, device clients of fedavg_mnist_mlp's 100
EXT_OP = "ext_fail_odd"
EXT_SOURCE = """import sys
sys.path.insert(0, {root!r})
from olearning_sim_tpu_torch.operators import OperatorABC


class FailOdd(OperatorABC):
    def run(self):
        return 1 if any(c % 2 for c in self.params["client_ids"]) else 0


FailOdd().main()
"""
SENT140_GOOD = ("love", "great", "happy", "awesome", "thanks", "fun")
SENT140_BAD = ("hate", "sad", "awful", "sick", "miss", "tired")


def write_sent140_zip(path, rows, users, test_rows, seed):
    """A Sent140 archive in the published layout: ``trainingandtestdata.zip``
    holding ``training.1600000.processed.noemoticon.csv`` and
    ``testdata.manual.2009.06.14.csv``, every field quoted, columns
    polarity,id,date,query,user,text. Words come from a seeded list of
    2,000; each tweet carries a sentiment word of its label (polarity 0 or
    4), so the task can learn. Returns the seconds it took."""
    import csv
    import io
    import zipfile

    import numpy as np

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(letters[rng.integers(0, 26, int(n))]) for n in rng.integers(3, 9, 2000)]

    def csv_bytes(n, first_id):
        label = rng.integers(0, 2, n)
        length = rng.integers(5, 20, n)
        words = rng.integers(0, len(vocab), (n, 20))
        senti = rng.integers(0, len(SENT140_GOOD), n)
        where = rng.integers(0, 20, n) % (length + 1)
        user = rng.integers(0, users, n)
        out = io.StringIO()
        w = csv.writer(out, quoting=csv.QUOTE_ALL, lineterminator="\n")
        for i in range(n):
            text = [vocab[j] for j in words[i, :length[i]]]
            text.insert(int(where[i]), (SENT140_GOOD if label[i] else SENT140_BAD)[senti[i]])
            w.writerow([4 * int(label[i]), first_id + i, "Mon Apr 06 22:19:45 PDT 2009",
                        "NO_QUERY", f"user{int(user[i]):05d}", " ".join(text)])
        return out.getvalue().encode()

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as zf:
        zf.writestr("training.1600000.processed.noemoticon.csv", csv_bytes(rows, 1467810369))
        zf.writestr("testdata.manual.2009.06.14.csv", csv_bytes(test_rows, 3))
    return time.perf_counter() - t0


def write_mnist_files(d, rows, seed):
    """MNIST's four gzipped IDX files (``train-images-idx3-ubyte.gz`` and
    siblings) in the published layout and sizes: 28x28 uint8 images, each
    a seeded class pattern over noise, and uint8 labels. Returns
    (train labels, file paths, seconds)."""
    import gzip
    import os
    import struct

    import numpy as np

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    patterns = (rng.random((10, 28, 28)) < 0.25).astype(np.uint8) * 159
    paths, train_labels = [], None
    for stem, n in zip(("train", "t10k"), rows):
        labels = rng.integers(0, 10, n).astype(np.uint8)
        images = rng.integers(0, 96, (n, 28, 28), dtype=np.uint8) + patterns[labels]
        for kind, arr in (("images-idx3", images), ("labels-idx1", labels)):
            path = os.path.join(d, f"{stem}-{kind}-ubyte.gz")
            header = bytes([0, 0, 0x08, arr.ndim]) + struct.pack(f">{arr.ndim}I", *arr.shape)
            with gzip.open(path, "wb", compresslevel=1) as f:
                f.write(header + arr.tobytes())
            paths.append(path)
        train_labels = labels if stem == "train" else train_labels
    return train_labels, paths, time.perf_counter() - t0


def data_edit(path, transfer, real):
    """An ``edit`` pointing the task's target data at an archive."""
    def edit(task):
        task["target"]["data"][0].update(data_path=path, data_transfer_type=transfer)
        params = _engine_params(task)
        params["data"]["real"] = real
        _set_engine_params(task, params)
        return f"data_path {path} over {transfer}; data.real {json.dumps(real)}"
    return edit


def external_edit(code_path):
    """An ``edit`` that appends an operator running external code from an
    archive fetched over FILE."""
    def edit(task):
        side = {"operator_transfer_type": "FILE", "operator_code_path": "",
                "operator_entry_file": "", "operator_params": ""}
        task["operatorflow"]["operators"].append({
            "name": EXT_OP, "input": ["train"], "use_data": True,
            "operation_behavior_controller": {"use_gradient_house": False,
                                              "strategy_gradient_house": "",
                                              "outbound_service": ""},
            "model": {"use_model": False, "model_for_train": False,
                      "model_transfer_type": "FILE", "model_path": "",
                      "model_update_style": ""},
            "logical_simulation": dict(side, operator_code_path=code_path,
                                       operator_entry_file="entry.py",
                                       operator_params="{}"),
            "device_simulation": side})
        return f"operator {EXT_OP}: external code {code_path} (FILE), entry.py"
    return edit


def _host_arrays(ds):
    """A population's arrays on the host: floats as float32, integers as
    int64 (the port keeps labels in int64 on the card)."""
    import numpy as np
    import torch

    out = {}
    for f in ("x", "y", "num_samples", "client_uid", "weight"):
        v = getattr(ds, f)
        if isinstance(v, torch.Tensor):
            v = (v.float() if v.is_floating_point() else v).cpu().numpy()
        v = np.asarray(v)
        out[f] = v.astype(np.int64 if v.dtype.kind in "iu" else np.float32)
    return out


def _same_population(label, a, b, eval_a, eval_b):
    """Two populations (and eval sets) bitwise equal, or fail."""
    import numpy as np

    ha, hb = _host_arrays(a), _host_arrays(b)
    same = {f: bool(ha[f].shape == hb[f].shape and np.array_equal(ha[f], hb[f])) for f in ha}
    same["eval"] = all(np.array_equal(np.asarray(x), np.asarray(y))
                       for x, y in zip(eval_a, eval_b))
    log(f"{label}: bitwise equal {same}")
    if not all(same.values()):
        raise AssertionError(f"{label}: the populations differ")


def dense_to_flash(params):
    """A dense-attention DistilBERT's parameters laid out for the flash
    model: each block's query, key and value projections stacked into its
    fused ``qkv`` (rows q, then k, then v, as the flash block splits them),
    ``out`` renamed ``attn_out``; every other tensor as it is."""
    import torch

    out = {}
    for name, v in params.items():
        head, _, leaf = name.rpartition(".")
        block, _, proj = head.rpartition(".")
        if proj == "query":
            out[f"{block}.qkv.{leaf}"] = torch.cat(
                [params[f"{block}.{p}.{leaf}"] for p in ("query", "key", "value")])
        elif proj in ("key", "value"):
            continue
        elif proj == "out":
            out[f"{block}.attn_out.{leaf}"] = v
        else:
            out[name] = v
    return out


def eval_logits(core, params, x):
    """The f32 logits of ``core``'s model over ``x`` in its eval batches, as
    :meth:`FedCore.evaluate` computes them (this rank's shards under mp)."""
    import torch
    from torch.func import functional_call

    dev = next(iter(params.values())).device
    bs = core.config.eval_batch_size
    local, kw = core._to_carry(params), core._forward_kwargs()
    with torch.no_grad():
        return torch.cat([functional_call(core._module(), local,
                                          (torch.as_tensor(x[i:i + bs]).to(dev),), kw).float()
                          for i in range(0, len(x), bs)])


def hold_k1_by_logits(label, flash_core, params, x, want, card, wrong_must_fail=True,
                      atol=EVAL_LOGITS_ATOL):
    """K1 held by logits: the flash model's logits over ``x`` within
    ``atol`` of ``want`` (the dense model's, or the flash model's at
    mp 1), and the same check failing two wrong kernels: K1 with its key
    mask dropped (padding attended) and with uniform weights (scores
    zeroed). Their launches are not counted: callers read K1's count first.
    Returns each wrong kernel's distance."""
    import torch

    from olearning_sim_tpu_torch.models import transformer

    got = eval_logits(flash_core, params, x)
    want = want.to(got.device)
    diff = float((got - want).abs().max())
    log(f"{label} logits max|flash - reference| {diff:.3e} over {len(x)} rows (tol "
        f"{atol:g}, reference max|.| {float(want.abs().max()):.3f}) | {card}")
    if not (bool(torch.isfinite(got).all()) and diff <= atol):
        raise AssertionError(f"{label}: the flash logits disagree with the reference")
    real_k1 = transformer.flash_attention
    wrong = {"key mask dropped": lambda q, k, v, kv_mask=None: real_k1(q, k, v),
             "uniform weights": lambda q, k, v, kv_mask=None: real_k1(q * 0, k, v,
                                                                      kv_mask=kv_mask)}
    moves = {}
    for what, k1 in wrong.items():
        transformer.flash_attention = k1
        try:
            moves[what] = float((eval_logits(flash_core, params, x) - want).abs().max())
        finally:
            transformer.flash_attention = real_k1
        log(f"{label} with K1's {what}: logits max|flash - reference| {moves[what]:.3e}, "
            f"{moves[what] / atol:.1f}x the tolerance")
        if wrong_must_fail and not moves[what] > atol:
            raise AssertionError(f"{label}: the logits check does not catch K1's {what}")
    return moves


class _HttpServer:
    """``http.server`` on 127.0.0.1 serving one directory from a thread."""

    def __init__(self, root):
        import http.server
        import threading

        class Quiet(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *a, **k):
                super().__init__(*a, directory=str(root), **k)

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


def ingest_path(dev, shrink=None):
    """Phase 17: task inputs from outside: real archives (local, over HTTP),
    external operator code, the hybrid split through the manager, and the
    optional client packages."""
    import importlib
    import os
    import tarfile
    import tempfile
    import zipfile

    import numpy as np
    import torch

    from olearning_sim_tpu_torch.data import ingest
    from olearning_sim_tpu_torch.data.formats import detect_and_load
    from olearning_sim_tpu_torch.data.partition import partition
    from olearning_sim_tpu_torch.engine import FedCoreConfig, build_fedcore, fedadam
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from olearning_sim_tpu_torch.operators import external
    from olearning_sim_tpu_torch.ops import flash_attention
    from olearning_sim_tpu_torch.phonemgr import SimulatedPhoneFarm
    from olearning_sim_tpu_torch.resourcemgr import DeviceTopology, ResourceManager
    from olearning_sim_tpu_torch.storage import HttpFileRepo
    from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig
    from olearning_sim_tpu_torch.taskmgr.scheduler import get_task_request_resource
    from olearning_sim_tpu_torch.taskmgr.status import TaskStatus
    from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo
    from olearning_sim_tpu_torch.telemetry import default_tracer

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_17_")
    # Extracted archives, staged halves and operator scratch go under it.
    previous_tempdir, tempfile.tempdir = tempfile.tempdir, tmp.name
    card = card_line() if dev.type == "cuda" else "cpu"
    ingest.clear_cache()

    # 17a: a Sent140 archive at full width, through K1.
    sent_zip = os.path.join(tmp.name, "trainingandtestdata.zip")
    secs = write_sent140_zip(sent_zip, SENT140_ROWS, SENT140_USERS, SENT140_TEST_ROWS,
                             INGEST_SEED)
    log(f"17a archive {os.path.basename(sent_zip)}: {SENT140_ROWS} training rows (cut from "
        f"1,600,000) from {SENT140_USERS} users, {SENT140_TEST_ROWS} test rows, "
        f"{os.path.getsize(sent_zip)} bytes, written in {secs:.2f} s")
    edit = _edits(block_edit(DISTILBERT_BLOCK) if shrink is None else None,
                  data_edit(sent_zip, "FILE", SENT140_REAL))
    clients = [64] if shrink is None else None
    runner_a, hist_a = run_task("17a", "fedadam_sent140_distilbert", dev, INGEST_ROUNDS,
                           clients=clients, edit=edit, shrink=shrink)
    task_a, _ = load_task("fedadam_sent140_distilbert", INGEST_ROUNDS, clients, edit, shrink)
    params_a = _engine_params(task_a)
    pop_a = runner_a.populations[0]
    ex, ey = pop_a.eval_data
    seq_len = int(params_a["model"]["input_shape"][0])
    vocab = int(params_a["model"]["overrides"].get("vocab_size", 30522))
    n_clients = pop_a.dataset.num_real_clients
    syn = params_a["data"]["synthetic"]
    load_kw = dict(num_clients=n_clients, n_local=SENT140_REAL["n_local"],
                   scheme=SENT140_REAL["scheme"],
                   alpha=float(syn.get("dirichlet_alpha") or 0.5), seed=int(syn["seed"]),
                   transfer_type=0, eval_n=params_a["data"]["eval_n"],
                   vocab_size=vocab, seq_len=seq_len)
    ingest.clear_cache()
    t0 = time.perf_counter()
    direct, direct_eval, _ = ingest.load_population(sent_zip, **load_kw)
    t_load = time.perf_counter() - t0
    _same_population("17a the bridge's population against load_population run again",
                     pop_a.dataset, direct, pop_a.eval_data, direct_eval)
    t0 = time.perf_counter()
    d = ingest.fetch_dataset_dir(sent_zip, 0)
    t_fetch = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, y, writer = detect_and_load(d, "train", vocab_size=vocab, seq_len=seq_len)
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    partition(x, y, n_clients, SENT140_REAL["n_local"], scheme="by_writer", writer=writer,
              seed=int(syn["seed"]))
    t_part = time.perf_counter() - t0
    log(f"17a ingest seconds: fetch and extract {t_fetch:.3f}, parse {t_parse:.3f} "
        f"({len(y)} rows, {len(np.unique(writer))} users), partition {t_part:.3f} "
        f"(by writer into {n_clients} clients), load_population whole {t_load:.3f} | {card}")

    log(f"17a at the config's local learning rate: eval acc per round "
        f"{[h['evaluate']['data_0']['eval_acc'] for h in hist_a]} | {card}")
    del runner_a

    # The witness: the same task on the same archive at a lower local
    # learning rate learns it, so the model K1 evaluates depends on its
    # attention (the config's rate diverges within a round at this width).
    lr_edit = params_edit(algorithm=dict(params_a["algorithm"], local_lr=WITNESS_LOCAL_LR))
    runner_w, hist_w = run_task("17a witness", "fedadam_sent140_distilbert", dev,
                                WITNESS_ROUNDS, clients=clients, edit=_edits(edit, lr_edit),
                                shrink=shrink)
    acc_w = hist_w[-1]["evaluate"]["data_0"]["eval_acc"]
    log(f"17a witness eval acc per round {[h['evaluate']['data_0']['eval_acc'] for h in hist_w]}"
        f" (held at {WITNESS_ACC:g} or above on the card) | {card}")
    if dev.type == "cuda" and not acc_w >= WITNESS_ACC:
        raise AssertionError(f"17a: the witness did not learn the archive (acc {acc_w:.4f})")

    over = dict(params_a["model"]["overrides"], attention_impl="flash")
    flash_core = build_fedcore("distilbert", fedadam(0.01, 0.001), FedCoreConfig(**MAIN_CFG),
                               model_overrides=over, input_shape=(seq_len,), device=dev)
    dense = runner_w.states["data_0"].params
    trained = dense_to_flash(dense)
    dloss, dacc = runner_w.core.evaluate(dense, ex, ey)
    dense_logits = eval_logits(runner_w.core, dense, ex)
    flash_attention.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    floss, facc = flash_core.evaluate(trained, ex, ey)
    _sync(dev)
    t_eval = time.perf_counter() - t0
    launches = flash_attention.launches
    depth = len(flash_core.model.blocks)
    batches = -(-len(ey) // flash_core.config.eval_batch_size)
    log(f"17a flash evaluate of the witness's model on the archive's {len(ey)} test rows: "
        f"loss={floss:.6f} acc={facc:.4f} seconds={t_eval:.4f}; dense loss={dloss:.6f} "
        f"acc={dacc:.4f}; K1 launches {launches} (depth {depth} x {batches} eval batches) "
        f"| {card}")
    if dev.type == "cuda" and launches != depth * batches:
        raise AssertionError(f"17a: K1 launched {launches} times, expected {depth * batches}")
    if not abs(floss - dloss) <= EVAL_LOSS_TOL:
        raise AssertionError("17a: the flash evaluate disagrees with the dense one")
    hold_k1_by_logits("17a", flash_core, trained, ex, dense_logits, card)
    n_cmp = min(64, len(ey))
    card_logits = eval_logits(flash_core, trained, ex[:n_cmp])
    cpu_logits = eval_logits(flash_core, {k: v.cpu() for k, v in trained.items()}, ex[:n_cmp])
    cdiff = float((card_logits.cpu() - cpu_logits).abs().max())
    log(f"17a flash eval batch of {n_cmp}: logits max|card - CPU path| {cdiff:.3e} "
        f"(tol {EVAL_LOGITS_ATOL:g})")
    if not cdiff <= EVAL_LOGITS_ATOL:
        raise AssertionError("17a: the flash evaluate on the card disagrees with the CPU path")
    del runner_w, flash_core, trained, dense

    # 17b: MNIST over HTTP, with an external operator.
    mnist_dir = os.path.join(tmp.name, "mnist")
    os.makedirs(mnist_dir)
    labels, files, secs = write_mnist_files(mnist_dir, MNIST_ROWS, INGEST_SEED)
    tar_path = os.path.join(tmp.name, "mnist.tar.gz")
    with tarfile.open(tar_path, "w:gz", compresslevel=1) as tf:
        for f in files:
            tf.add(f, f"mnist/{os.path.basename(f)}")
    code_zip = os.path.join(tmp.name, "fail_odd.zip")
    with zipfile.ZipFile(code_zip, "w") as zf:
        zf.writestr("entry.py", EXT_SOURCE.format(root=str(ROOT)))
    log(f"17b archive mnist.tar.gz: {MNIST_ROWS[0]} train and {MNIST_ROWS[1]} test rows of "
        f"28x28 uint8 in four gzipped IDX files, {os.path.getsize(tar_path)} bytes, written "
        f"in {secs:.2f} s; operator code {os.path.basename(code_zip)} "
        f"({os.path.getsize(code_zip)} bytes)")
    srv = _HttpServer(tmp.name)
    try:
        url = f"{srv.url}/mnist.tar.gz"
        t0 = time.perf_counter()
        if not HttpFileRepo().download_file(url, os.path.join(tmp.name, "fetched.tar.gz")):
            raise AssertionError(f"17b: {url} did not download")
        t_http = time.perf_counter() - t0
        log(f"17b HTTP fetch of {url}: {t_http:.4f} s "
            f"({os.path.getsize(tar_path) / t_http / 1e6:.1f} MB/s)")
        runner_b, hist_b = run_task("17b", "fedavg_mnist_mlp", dev, INGEST_ROUNDS,
                                    edit=_edits(data_edit(url, "HTTP", MNIST_REAL),
                                                external_edit(code_zip)),
                                    shrink=shrink)
    finally:
        srv.close()
    ext_secs = [sp.duration_s for sp in default_tracer().spans()
                if sp.name == f"round.{EXT_OP}.custom"]
    file_task, _ = load_task("fedavg_mnist_mlp", INGEST_ROUNDS,
                             edit=data_edit(tar_path, "FILE", MNIST_REAL), shrink=shrink)
    runner_f = build_runner_from_taskconfig(file_task, device=dev)
    _same_population("17b the HTTP population against the same archive over FILE",
                     runner_b.populations[0].dataset, runner_f.populations[0].dataset,
                     runner_b.populations[0].eval_data, runner_f.populations[0].eval_data)
    del runner_f
    pop_b = runner_b.populations[0]
    real = pop_b.dataset.num_real_clients
    counts = [h[EXT_OP]["data_0"] for h in hist_b]
    log(f"17b {EXT_OP} per round {counts}; wall seconds per round "
        f"{[round(s, 4) for s in ext_secs]} ({real} subprocesses a round, "
        f"{external.MAX_WORKERS} at a time) | {card}")
    want = {"success": (real + 1) // 2, "failed": real // 2}
    if any(c != want for c in counts):
        raise AssertionError(f"17b: the external operator's counts are not {want}")
    # The run's end removed the operator's fetched code and save root.
    op = runner_b.operators[-1].custom_fn
    if os.path.exists(op.code_dir) or os.path.exists(op.save_dir):
        raise AssertionError("17b: the finished run left its operator's scratch directories")
    # What one of those subprocesses costs, one at a time (median of 3), from
    # a copy of the operator's code.
    probe = os.path.join(tmp.name, "probe_code")
    with zipfile.ZipFile(code_zip) as zf:
        zf.extractall(probe)
    entry = [os.path.join(probe, op.entry_file), "--params",
             json.dumps(op._batch_params("t", 0, EXT_OP, "data_0", [0],
                                         os.path.join(tmp.name, "probe")))]
    starts = {}
    # (A fresh process's torch import is timed by each 18c segment.)
    for what, argv in (("bare interpreter", ["-c", "pass"]),
                       ("import numpy", ["-c", "import numpy"]),
                       ("the operator's entry", entry)):
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            subprocess.run([sys.executable] + argv, cwd=probe, capture_output=True)
            secs.append(time.perf_counter() - t0)
        starts[what] = sorted(secs)[1]
    log("17b one subprocess at a time, median of 3: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in starts.items()) + f" | {card}")
    x_b = pop_b.dataset.x[:real]
    if not bool(torch.isfinite(x_b.float()).all()):
        raise AssertionError("17b: the train rows are not finite")

    # 17c: the hybrid split through the manager.
    mnist_zip = os.path.join(tmp.name, "mnist.zip")
    with zipfile.ZipFile(mnist_zip, "w") as zf:
        for f in files:
            zf.write(f, os.path.basename(f))
    logical_n, device_n = HYBRID_ALLOCATION

    def hybrid_edit(task):
        td = task["target"]["data"][0]
        td.update(data_split_type=True)
        td["total_simulation"]["nums"] = [logical_n + device_n]
        td["allocation"].update(logical_simulation=[logical_n], device_simulation=[device_n])
        task["device_simulation"]["resource_request"] = [
            {"name": td["name"], "devices": td["total_simulation"]["devices"],
             "num_request": [device_n]}]
        return (f"data_split_type true, allocation logical {logical_n} device {device_n}, "
                f"device request {device_n}")

    task_c, cuts = load_task("fedavg_mnist_mlp", INGEST_ROUNDS,
                             edit=data_edit(mnist_zip, "FILE", MNIST_REAL), shrink=shrink)
    cuts.append(hybrid_edit(task_c))  # after any shrink: the allocation stays whole
    task_c["task_id"] = "chip_smoke_17c"
    log("17c fedavg_mnist_mlp: " + "; ".join(cuts))

    class RecordingFarm(SimulatedPhoneFarm):
        """A phone farm whose device rounds take no time; records jobs."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.submitted = []

        def submit_task(self, task_id, rounds, operators, data):
            self.submitted.append(data)
            return super().submit_task(task_id, rounds, operators, data)

    farm = RecordingFarm(inventory={task_c["user_id"]: {"hpc": device_n}}, speedup=1e9)
    req = get_task_request_resource(json2taskconfig(task_c))["logical_simulation"]
    units = max(req["cpu"], req["mem"])
    rm = ResourceManager(topology=DeviceTopology.detect(dev, units_per_core=units,
                                                        mem_per_core=units),
                         phone_provider=farm.get_device_available_resource)
    repo = TaskTableRepo(sqlite_path=os.path.join(tmp.name, "tasks.db"))
    mgr = TaskManager(task_repo=repo, resource_manager=rm, phone_client=farm,
                      schedule_interval=3600, device=dev)
    if not mgr.submit_task(task_c):
        raise AssertionError("17c: the manager refused the hybrid task")
    t0 = time.perf_counter()
    if mgr.schedule_once() != task_c["task_id"]:
        raise AssertionError("17c: the hybrid task was not launched")
    t_stage = time.perf_counter() - t0
    staged = mgr._device_paths[(task_c["task_id"], "data_0")]
    stored = json.loads(repo.get_item_value(task_c["task_id"], "task_params"))
    logical_path = stored["target"]["data"][0]["data_path"]
    ingest.clear_cache()
    rows = {"logical": len(ingest.load_arrays(logical_path)[1]),
            "device": len(ingest.load_arrays(staged)[1])}
    frac = device_n / (logical_n + device_n)
    reckoned = sum(int(round(int(np.sum(labels == k)) * frac)) for k in range(10))
    job = mgr._launcher.get_job(repo.get_item_value(task_c["task_id"], "job_id"))
    _wait(lambda: job.status not in (TaskStatus.PENDING, TaskStatus.RUNNING), 600,
          "17c's job")
    mgr.release_once()
    status = repo.get_item_value(task_c["task_id"], "task_status")
    routed = farm.submitted[0][0].get("data_path") if farm.submitted else None
    log(f"17c staged and launched in {t_stage:.3f} s; rows logical {rows['logical']} device "
        f"{rows['device']} (reckoned device {reckoned} = sum over labels of round(n x "
        f"{frac:g}), of {len(labels)}); phone job data_path {routed}; logical half "
        f"{job.status.name}, logical_round {repo.get_item_value(task_c['task_id'], 'logical_round')}, "
        f"task {status}; staged shard removed at the release: {not os.path.exists(staged)} "
        f"| {card}")
    if rows != {"logical": len(labels) - reckoned, "device": reckoned}:
        raise AssertionError("17c: the halves' rows differ from the stratified reckoning")
    if routed != staged or not staged.endswith("_device.zip"):
        raise AssertionError("17c: the phone job did not get the device shard's path")
    if status != TaskStatus.SUCCEEDED.name or os.path.exists(staged):
        raise AssertionError(f"17c: the task ended {status} (job error {job.error})")

    # 17d: the optional client packages.
    def importable(name):
        try:
            importlib.import_module(name)
            return True
        except ImportError:
            return False

    for package, word, block in (
            ("websocket", "websocket-client",
             params_edit(operator_flow={"selection_url": "ws://127.0.0.1:9"})),
            ("boto3", "boto3", None), ("minio", "minio", None)):
        have = importable(package)
        if block is None:
            kind = "S3" if package == "boto3" else "MINIO"
            block = _edits(model_edit(tmp.name, model_update_style="{task_id}_{round}"),
                           params_edit(storage={"endpoint": "127.0.0.1:9", "access_key": "k",
                                                "secret_key": "s", "bucket": "b"}))
            block = _edits(block, _transfer_edit(kind))
        task_d, cuts = load_task("fedavg_mnist_mlp", 1, edit=block, shrink=shrink)
        try:
            build_runner_from_taskconfig(task_d, device=dev)
            outcome = None
        except (ImportError, RuntimeError) as e:
            outcome = e
        log(f"17d {package} imports: {have}; a task with {'; '.join(cuts[1:])}: "
            + ("built" if outcome is None else f"{type(outcome).__name__}: {outcome}"))
        if have != (outcome is None) or (outcome is not None and word not in str(outcome)):
            raise AssertionError(f"17d: {package}: the build does not follow the import")
    ingest.clear_cache()
    tempfile.tempdir = previous_tempdir
    tmp.cleanup()
    log(f"phase 17 seconds: {time.perf_counter() - t_phase:.1f}")


def _transfer_edit(kind):
    """An ``edit`` that sets the train operator's model transfer type."""
    def edit(task):
        task["operatorflow"]["operators"][0]["model"]["model_transfer_type"] = kind
        return f"model_transfer_type {kind}"
    return edit


ELASTIC_SEGMENT_ROUNDS = 1
ELASTIC_WORLDS = (1, 2, 1)
# 18c: the rescaled run against the fixed world, relative L2 over all
# parameters (the same draws; dp 2 sums the clients' deltas in another
# order).
ELASTIC_REL = 1e-5
LAUNCH_TIMEOUT_S = 300
TARGETS = "olearning_sim_tpu_torch.clustermgr.targets"


def cluster_path(dev):
    """Phase 18: the convergence gate on the card, worlds of worker
    processes (K2 in 18b's ring workers) and an elastic 1-2-1 rescale. On
    the CPU (a rehearsal) the worlds run there, over gloo."""
    import torch

    t_phase = time.perf_counter()
    card = card_line()
    gate_on_card(dev, card)
    if dev.type == "cuda":
        # The workers share the card with this process: hand back what its
        # allocator caches from earlier phases.
        torch.cuda.empty_cache()
    with ThreadPoolExecutor(1) as pool:
        worlds = pool.submit(worlds_on_card, dev, card)
        try:
            elastic_on_card(dev, card)
        finally:
            worlds.result()
    log(f"phase 18 seconds: {time.perf_counter() - t_phase:.1f}")


def gate_on_card(dev, card):
    """18a: the gate's entries on ``dev`` against the CPU-blessed envelopes."""
    from olearning_sim_tpu_torch.analysis import convergence_gate as gate

    env = gate.load_envelopes()
    problems = []
    for name in gate.GATE_ENTRIES:
        t0 = time.perf_counter()
        rec = gate.run_entry(name, device=dev)
        secs = time.perf_counter() - t0
        want = env["entries"][name]
        found = gate.compare(name, rec, want, env.get("tolerances"))
        problems += found
        log(f"18a {name}: final_accuracy {rec['final_accuracy']:.4f} (CPU-blessed "
            f"{want['final_accuracy']:.4f}), best {rec['best_accuracy']:.4f} "
            f"({want['best_accuracy']:.4f}), at round budget "
            f"{rec['accuracy_at_round_budget']:.4f} ({want['accuracy_at_round_budget']:.4f}), "
            f"reached {rec['reached']} ({want['reached']}), rounds_to_target "
            f"{rec['rounds_to_target']} ({want['rounds_to_target']}), {secs:.2f} s"
            f"{' FINDINGS ' + str(found) if found else ''} | {card}")
    if problems:
        raise AssertionError(f"18a: the convergence gate fails on the card: {problems}")


def worlds_on_card(dev, card):
    """18b: worlds of worker processes, K2 in the ring workers."""
    from olearning_sim_tpu_torch.clustermgr import MultiHostLauncher

    t0 = time.perf_counter()
    one = MultiHostLauncher(1, coordinator_port=_free_port(), platform=dev.type)
    res = one.launch(f"{TARGETS}:smoke_round", timeout=LAUNCH_TIMEOUT_S)
    log(f"18b smoke_round, world 1 over {one.backend}, {time.perf_counter() - t0:.1f} s: "
        f"{res[0].stdout.strip().splitlines()[-1]} | {card}")
    t0 = time.perf_counter()
    res = MultiHostLauncher(2, coordinator_port=_free_port(), platform=dev.type,
                            backend="gloo").launch(f"{TARGETS}:smoke_ring_sp",
                                                   args=["flash", "full"],
                                                   timeout=LAUNCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for rank, r in enumerate(res):
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("smoke_ring_sp ")]
        line = [ln for ln in lines if ln.startswith("smoke_ring_sp ok")][-1]
        launches = int(re.search(r"K2 launches=(\d+)", line)[1])
        for ln in lines:
            log(f"18b world 2 over gloo on one card, rank {rank}: {ln} | {card}")
        if dev.type == "cuda" and not launches:
            raise AssertionError(f"18b rank {rank}: the ring ran no K2 launch")
    log(f"18b smoke_ring_sp world of 2: {wall:.1f} s")


def elastic_on_card(dev, card):
    """18c: phase 4's DistilBERT FedAdam task, world 1 -> 2 -> 1, two ranks
    sharing the card when the slice holds two, against a fixed-world run at
    dp 1."""
    import os
    import tempfile

    from olearning_sim_tpu_torch.checkpoint import RoundCheckpointer
    from olearning_sim_tpu_torch.clustermgr import ClusterManager, ElasticWorldRunner
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    with tempfile.TemporaryDirectory(prefix="chip_smoke_18_") as work:
        mgr = ClusterManager(devices=[dev] * max(ELASTIC_WORLDS))
        mgr.create_slice("elastic", ELASTIC_WORLDS[0], user_id="chip_smoke")
        runner = ElasticWorldRunner(
            mgr, "elastic", os.path.join(work, "ckpt"), target=f"{TARGETS}:elastic_text_segment",
            segment_rounds=ELASTIC_SEGMENT_ROUNDS,
            coordinator_port=_free_port(), segment_timeout=LAUNCH_TIMEOUT_S,
            platform=dev.type, backend="gloo")

        def controller(segment, _done):
            runner.request_rescale(ELASTIC_WORLDS[segment])

        total = ELASTIC_SEGMENT_ROUNDS * len(ELASTIC_WORLDS)
        t0 = time.perf_counter()
        worlds = runner.run(total_rounds=total, between_segments=controller)
        wall = time.perf_counter() - t0
        plan = make_mesh_plan()
        core, ds = distilbert_setup(dev, plan)
        cp = RoundCheckpointer(os.path.join(work, "ckpt"))
        got = cp.restore({"d": core.init_state(seed=0, device=dev)}, {})
        cp.close()
    if worlds != list(ELASTIC_WORLDS) or got is None:
        raise AssertionError(f"18c: worlds {worlds}, checkpoint {'found' if got else 'missing'}")
    _, states, _, hist = got
    seen = [h["world"] for h in hist]
    want_worlds = [w for w in ELASTIC_WORLDS for _ in range(ELASTIC_SEGMENT_ROUNDS)]
    state = core.init_state(seed=0, device=dev)
    for _ in range(total):
        state, _ = core.round_step(state, ds)
    rel = _rel_l2(_host(states["d"].params), _host(state.params))
    summary = runner.overhead_summary()
    log(f"18c elastic worlds {worlds} over {total} rounds in {wall:.1f} s; history worlds "
        f"{seen}; final params vs the fixed world at dp 1: relative L2 {rel:.3e} (limit "
        f"{ELASTIC_REL:g}) | {card}")
    log(f"18c overhead_summary: {json.dumps(summary)} | {card}")
    if seen != want_worlds or not rel <= ELASTIC_REL:
        raise AssertionError("18c: the elastic run differs from the fixed world")


# Phase 19: the repository checks on the card. 19d's check_all must exit
# within this of phase 19's start (it records the grid on the CPU, its dp-2
# and dp-2 x mp-2 worlds in spawned processes).
CHECK_ALL_TIMEOUT_S = 300
SYNC_WARNING = "called a synchronizing CUDA operation"


class CardProbe:
    """19a's counters on the card, one ``torch.profiler`` session over all
    of phase 19's recorded runs. Per run (``probe()``, a context manager
    entered inside the recorded window; one entry in ``runs``): the CUDA
    kernels launched and the memory copies and sets, the host syncs
    ``torch.cuda.set_sync_debug_mode("warn")`` reported, and the peak
    device memory above what was allocated when the run began.

    Launches are counted from the profiler's host-side records of the
    launch calls, not from its device events: in a long process the
    profiler drops some device events of every session, more the older
    the process (``analysis/profiler_clock.py``; PERF.md), and it kept
    every launch record. A run is the records between its two marks, by
    correlation id (CUPTI numbers the calls in the order they are made);
    a mark is a spin kernel launched alone inside a ``record_function``
    annotation, MARK_PAD_S of nothing on either side of it, so that its
    launch record is the one launch inside the annotation."""

    MARK = "chip_smoke.19a.mark"
    MARK_PAD_S = 0.005
    MARK_CYCLES = 1_000  # about a microsecond
    COPY_NAMES = ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")

    def __init__(self, dev):
        self.dev = dev
        self.runs = []
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._count()
        return False

    def _mark(self):
        import torch
        from torch.profiler import record_function

        with record_function(self.MARK):
            time.sleep(self.MARK_PAD_S)
            torch.cuda._sleep(self.MARK_CYCLES)
            time.sleep(self.MARK_PAD_S)

    @contextlib.contextmanager
    def probe(self):
        import warnings

        import torch

        torch.cuda.synchronize(self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        held = torch.cuda.memory_allocated(self.dev)
        self._mark()  # the run's start
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(0)
        self._mark()  # the run's end
        torch.cuda.synchronize(self.dev)
        self.runs.append({
            "syncs": sum(SYNC_WARNING in str(w.message) for w in caught),
            "peak": torch.cuda.max_memory_allocated(self.dev) - held,
        })

    def _count(self):
        from torch.autograd import DeviceType

        from olearning_sim_tpu_torch.analysis.profiler_clock import LAUNCH_NAMES

        # The raw events: building the profiler's event tree over the
        # runs' hundred thousand CPU operations costs minutes.
        events = list(self._prof.profiler.kineto_results.events())
        host = [e for e in events if e.device_type() != DeviceType.CUDA]
        calls = sorted((e.correlation_id(), e.start_ns(), e.name()) for e in host
                       if e.name().startswith(LAUNCH_NAMES + self.COPY_NAMES))
        launches = sorted((t, cid) for cid, t, name in calls if name.startswith(LAUNCH_NAMES))
        times = [t for t, _ in launches]
        marks = []
        for s, e in sorted((e.start_ns(), e.end_ns()) for e in host if e.name() == self.MARK):
            inside = [cid for _, cid in launches[bisect.bisect_left(times, s):
                                                  bisect.bisect_right(times, e)]]
            if len(inside) != 1:
                raise AssertionError(f"19a: a mark annotation holds {len(inside)} launch "
                                     f"records, not its spin kernel's one")
            marks += inside
        if len(marks) != 2 * len(self.runs):
            raise AssertionError(f"19a: the profiler kept {len(marks)} of the runs' "
                                 f"{2 * len(self.runs)} marks")
        for i, run in enumerate(self.runs):
            lo, hi = marks[2 * i], marks[2 * i + 1]
            names = [name for cid, _, name in calls if lo < cid < hi]
            copies = sum(n.startswith(self.COPY_NAMES) for n in names)
            run.update(kernels=len(names) - copies, copies=copies)
        # What the device events alone would have counted.
        seen = {e.correlation_id() for e in events if e.device_type() == DeviceType.CUDA}
        self.device_kept = (sum(cid in seen for _, cid in launches), len(launches))


def grid_flash_rows(model):
    """19c's rows: the grid's flash-evaluate rows of ``model`` with seeded padded tails
    (row i keeps 1 to all of its tokens), so what K1 computes depends on
    its key mask."""
    import numpy as np

    from olearning_sim_tpu_torch.analysis import grid
    from olearning_sim_tpu_torch.engine import make_central_text_eval_set

    spec = grid.GRID_MODELS[model]
    L = spec["input_shape"][0]
    x, _ = make_central_text_eval_set(0, grid.FLASH_EVAL_ROWS, L,
                                      vocab_size=spec["overrides"]["vocab_size"])
    keep = np.random.default_rng(PAD_SEED).integers(1, L + 1, size=len(x))
    return np.where(np.arange(L)[None, :] < keep[:, None], x, 0).astype(x.dtype)


def eval_logits_with(core, params, x, attention):
    """:func:`eval_logits` with the transformer's attention swapped for
    ``attention`` (K1's plain version: the reference)."""
    from olearning_sim_tpu_torch.models import transformer

    real = transformer.flash_attention
    transformer.flash_attention = attention
    try:
        return eval_logits(core, params, x)
    finally:
        transformer.flash_attention = real


def plant_knob_branch(core, variant):
    """19b's first fault: the deadline read on the host through a Python
    branch, so the two knob settings dispatch different operations."""
    inner = core.round_step

    def round_step(state, ds, **kw):
        if kw.get("deadline", 0.0) > 1.0:
            kw = dict(kw, completion_time=kw["completion_time"] * 1.0)
        return inner(state, ds, **kw)
    core.round_step = round_step


def plant_item(core, variant):
    """19b's second fault: a host read of the round's weight sum inside
    the round."""
    inner = core._finish_round

    def finish(state, sums, *args, **kwargs):
        float(sums.sum_w)
        return inner(state, sums, *args, **kwargs)
    core._finish_round = finish


class CheckAll:
    """19d's ``check_all --skip convergence`` in a background process, its
    output in a temporary file; ``main`` starts it before phase 8, so that
    its CPU recording overlaps the host-bound phases. ``stop()`` ends the
    process if it still runs."""

    def __init__(self):
        import tempfile

        self.out = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "olearning_sim_tpu_torch.analysis.check_all",
             "--skip", "convergence"], cwd=ROOT, stdout=self.out,
            stderr=subprocess.STDOUT, text=True)

    def wait(self, timeout):
        """(exit code, check_all's report lines)."""
        rc = self.proc.wait(timeout=timeout)
        self.out.seek(0)
        return rc, [ln for ln in self.out.read().splitlines()
                    if ln.startswith("check_all:") or ln.startswith("  ")]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()


def analysis_path(dev, check_all=None):
    """Phase 19: every dp-1 variant of the analysis grid on the card under
    both knob settings (operation sequences, kernel launches, host syncs,
    peak memory), two planted faults that must fail those checks, the
    flash evaluate's K1 launches and values, and ``check_all`` on the
    card machine's Python and torch (a :class:`CheckAll`, started here
    when not given)."""
    from olearning_sim_tpu_torch.analysis import grid, op_audit, retrace
    from olearning_sim_tpu_torch.analysis.op_trace import first_diff
    from olearning_sim_tpu_torch.ops import flash_attention, flash_attention_stats
    from olearning_sim_tpu_torch.ops.flash_attention import flash_attention_reference

    t_phase = time.perf_counter()
    card = card_line()
    if check_all is None:
        check_all = CheckAll()
    try:
        budgets = op_audit.load_budgets()["variants"]
        done = []
        with CardProbe(dev) as session:
            for v in (v for v in grid.variant_grid() if v.dp * v.mp == 1):
                if v.program == grid.FLASH_EVAL:
                    flash_attention.launches = flash_attention_stats.launches = 0
                first = len(session.runs)
                t0 = time.perf_counter()
                art = grid.record_variant(v, device=dev, probe=session.probe)
                done.append((v, art, first, time.perf_counter() - t0))
                if v.program == grid.FLASH_EVAL:
                    # Read just after: the warm-up run and both recorded runs.
                    counts = (flash_attention.launches, flash_attention_stats.launches)
                    flash = (v, art, budgets[v.name])
            # 19b: the two planted faults, each in a core the phase builds.
            planted = []
            for name, plant in (("deadline/shard0/dp1", plant_knob_branch),
                                ("plain/shard0/dp1", plant_item)):
                first = len(session.runs)
                v = grid.variant_by_name(name)
                planted.append((v, grid.record_variant(v, device=dev, plant=plant,
                                                       probe=session.probe), first))
        log(f"19a one profiler session over {len(session.runs)} runs: launches counted "
            f"from the launch records; the profiler kept the device events of "
            f"{session.device_kept[0]} of the session's {session.device_kept[1]} launches | "
            f"{card}")
        problems = []
        for v, art, first, secs in done:
            a, b = art["a"], art["b"]
            ra, rb = session.runs[first:first + 2]
            cpu = budgets[v.name]["host_syncs"]
            diff = first_diff(a, b)
            log(f"19a {v.name}: ops {len(a.ops)}/{len(b.ops)} "
                f"({'equal' if diff is None else diff}), kernel launches "
                f"{ra['kernels']}/{rb['kernels']}, copies {ra['copies']}/{rb['copies']}, "
                f"host syncs {ra['syncs']}/{rb['syncs']} (CPU recorder {cpu}, card recorder "
                f"{a.syncs}), the round's peak memory {ra['peak']}/{rb['peak']} B, params "
                f"{art['params_bytes']} B, state {art['state_bytes']} B, {secs:.2f} s "
                f"(build, warm-up, both runs) | {card}")
            if diff is not None:
                problems.append(f"{v.name}: operations differ between A and B: {diff}")
            if ra["kernels"] != rb["kernels"]:
                problems.append(f"{v.name}: kernel launches {ra['kernels']} vs {rb['kernels']}")
            if not ra["syncs"] == rb["syncs"] == cpu == a.syncs:
                problems.append(f"{v.name}: host syncs on the card {ra['syncs']}/{rb['syncs']}, "
                                f"CPU recorder {cpu}, card recorder {a.syncs}")
        if problems:
            raise AssertionError(f"19a: {problems}")

        (v, art, first), (v2, art2, first2) = planted
        found = retrace.compare_variant(art)
        ka, kb = session.runs[first]["kernels"], session.runs[first + 1]["kernels"]
        log(f"19b knob in a Python branch ({v.name}): retrace {len(found)} finding(s) "
            f"({found[0][:160] if found else ''}), kernel launches {ka}/{kb} | {card}")
        if not found or ka == kb:
            raise AssertionError("19b: the knob branch passed the retrace or launch check")
        found = op_audit.compare(v2.name, op_audit.measure(art2), budgets[v2.name],
                                 program=v2.program)
        syncs = session.runs[first2]["syncs"]
        log(f"19b .item() in the round ({v2.name}): host syncs on the card {syncs} (budget "
            f"{budgets[v2.name]['host_syncs']}), audit {len(found)} finding(s) "
            f"({found[0][:160] if found else ''}) | {card}")
        if syncs == budgets[v2.name]["host_syncs"] or not found:
            raise AssertionError("19b: the planted .item() passed the sync checks")

        # 19c: K1 in the tiny DistilBERT's flash evaluate.
        v, art, budget = flash
        depth = grid.GRID_MODELS["distilbert"]["overrides"]["depth"]
        batches = -(-grid.FLASH_EVAL_ROWS // grid.FLASH_EVAL_BATCH)
        launches = [art["info"][s]["flash_launches"] for s in ("a", "b")]
        log(f"19c flash evaluate (depth {depth}, {batches} eval batches): K1 launches "
            f"{launches[0]}/{launches[1]} a run, {counts[0]} over the warm-up and both runs "
            f"(K2 {counts[1]}), wrapper calls {art['info']['a']['flash_calls']} (CPU budget "
            f"{budget['flash_calls']}) | {card}")
        want = depth * batches if dev.type == "cuda" else 0
        if launches != [want] * 2 or counts != (3 * want, 0) \
                or budget["flash_calls"] != depth * batches:
            raise AssertionError(f"19c: K1 launched {launches} ({counts}), expected {want}")
        # K1's values at this shape (D 8, 8 keys): the evaluate's logits on
        # rows with padded tails against the same core's with K1's plain
        # version, after the counts were read.
        core, state = grid._core(v, dev)[:2]
        x = grid_flash_rows(v.model)
        want = eval_logits_with(core, state.params, x, flash_attention_reference)
        hold_k1_by_logits("19c", core, state.params, x, want, card)

        # 19d: check_all on this machine.
        t0 = time.perf_counter()
        rc, lines = check_all.wait(max(1.0, CHECK_ALL_TIMEOUT_S - (t0 - t_phase)))
    finally:
        check_all.stop()
    for ln in lines:
        log(f"19d {ln}")
    log(f"19d check_all --skip convergence: exit {rc} (waited {time.perf_counter() - t0:.1f} s "
        f"after 19a-19c) | {card}")
    if rc != 0:
        raise AssertionError(f"19d: check_all exited {rc}")
    log(f"phase 19 seconds: {time.perf_counter() - t_phase:.1f}")


# Phase 20: the port's examples (``olearning_sim_tpu_torch/examples/``), the
# JAX package's eight at their own sizes, seeds, rounds and worlds. 20a runs
# the in-process ones here; 20b the multi-rank ones, one process a rank
# sharing the card over gloo, started beside phase 10 (on an H100 80GB
# HBM3 at 700.00 W they took 156 s alone, each world's ranks paying the
# interpreter and torch's import again, and beside phases 18-19 slowed 18
# by 55 s). Each example's own checks hold inside its ``run``.
EXAMPLES_IN_PROCESS = ("library_quickstart", "custom_operator", "queue_submit",
                       "platform_submit")
EXAMPLES_WORLDS = ("tensor_pipeline_parallel", "moe_expert_parallel", "long_context_training",
                   "elastic_rescale")


def run_example(label, name, dev, card) -> float:
    """One example's ``run`` on ``dev``: its lines printed, its seconds
    returned."""
    import importlib

    module = importlib.import_module(f"olearning_sim_tpu_torch.examples.{name}")
    t0 = time.perf_counter()
    result = module.run(dev)
    secs = time.perf_counter() - t0
    for line in module.report(result):
        log(f"{label} {name}: {line}")
    log(f"{label} {name}: {secs:.1f} s | {card}")
    return secs


def example_worlds(dev, card) -> float:
    """20b: the multi-rank examples in turn; returns their wall seconds."""
    t0 = time.perf_counter()
    for name in EXAMPLES_WORLDS:
        run_example("20b", name, dev, card)
    return time.perf_counter() - t0


def start_prebuilt():
    """20c's process: ``python -m olearning_sim_tpu_torch.ops._build`` (the
    GPU image's build step), started beside 20a."""
    return subprocess.Popen([sys.executable, "-m", "olearning_sim_tpu_torch.ops._build"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True), time.perf_counter()


def prebuilt_check(started, card):
    """20c: the build entry (``start_prebuilt``'s process) must build or find
    exactly the libraries this process loaded in phase 2."""
    from olearning_sim_tpu_torch.ops import _build

    loaded = {src: pathlib.Path(_build.load(src)._name).resolve() for src in _build.sources()}
    proc, t0 = started
    stdout, stderr = proc.communicate(timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"20c: the kernel build exited {proc.returncode}:\n"
                             f"{stdout}{stderr}")
    fresh = {}
    for line in stdout.splitlines():
        src, word, lib = line.split(" ", 2)
        fresh[src] = pathlib.Path(lib).resolve()
        log(f"20c {src}: {word} {lib} (loaded here: {loaded.get(src)})")
    log(f"20c python -m olearning_sim_tpu_torch.ops._build: {secs:.1f} s from its start "
        f"beside 20a | {card}")
    if fresh != loaded:
        raise AssertionError(f"20c: the build entry's libraries {fresh} are not the loaded "
                             f"ones {loaded}")


def examples_path(dev, worlds, t_worlds):
    """Phase 20: 20a here with 20c's process beside it, then 20b's worlds
    (``worlds``, a future started at ``t_worlds``) awaited, then 20c's
    check. K1's and K2's counts are zeroed before 20a and read after it
    (no example runs flash attention: the long-context example's ring
    combines in plain PyTorch, as the JAX example's; 20b's counts are its
    ranks')."""
    from olearning_sim_tpu_torch.ops import flash_attention, flash_attention_stats

    t_phase = time.perf_counter()
    card = card_line()
    prebuilt = start_prebuilt()
    flash_attention.launches = flash_attention_stats.launches = 0
    secs = {name: run_example("20a", name, dev, card) for name in EXAMPLES_IN_PROCESS}
    log(f"20a K1 launches {flash_attention.launches}, K2 launches "
        f"{flash_attention_stats.launches}; seconds {json.dumps(secs)}")
    t_wait = time.perf_counter()
    wall = worlds.result()
    log(f"20b the four worlds: {wall:.1f} s from their start beside phase 10, "
        f"{time.perf_counter() - t_wait:.1f} s waited after 20a")
    prebuilt_check(prebuilt, card)
    log(f"phase 20 seconds: {time.perf_counter() - t_phase:.1f} after phase 19 "
        f"(20b started {t_phase - t_worlds:.1f} s before, beside phase 10 on)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (pathlib.Path(__file__).resolve().parent / "olearning_sim_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(olearning_sim_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card_line()
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")
    build_all()
    k1 = kernel_phase(dev)
    k2 = stats_kernel_phase(dev)
    k1["bfloat16"]["launches"] = main_path(dev)
    k2["bfloat16"]["launches"] = long_context_path(dev)
    k1["float32"]["launches"], k2["float32"]["launches"] = f32_path(dev)
    headline_path(dev)
    check_all = CheckAll()  # 19d, in the background from here
    try:
        task_path(dev)
        robust_path(dev)
        with ThreadPoolExecutor(1) as pool:
            t_worlds = time.perf_counter()
            # 20b, beside phase 10 on (mostly one busy core: resnet18's
            # rounds wait on the card, vit_tiny's on one launching thread).
            worlds = pool.submit(example_worlds, dev, card_line())
            families_path(dev)
            stream_path(dev)
            async_path(dev)
            dp_path(dev)
            mp_path(dev)
            control_path(dev)
            platform_path(dev)
            ingest_path(dev)
            cluster_path(dev)
            analysis_path(dev, check_all)
            examples_path(dev, worlds, t_worlds)
    finally:
        check_all.stop()
    log(f"chip_smoke seconds: {time.perf_counter() - STARTED:.1f}")
    log(json.dumps({"kernels": [k1["bfloat16"], k1["float32"], k2["bfloat16"],
                                k2["float32"]]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
