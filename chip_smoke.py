#!/usr/bin/env python3
"""Run the PyTorch + CUDA port's serving (f32 and int8), row-sharded,
column-sharded, training, table-lifecycle, model-zoo, embed-API, retrieval,
table-group (single-device and sharded), command-line, HTTP-over-S-ranks
and entry-point paths, its measurement harnesses and its random-row copy
probe on one card and check them.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero and prints no result line):

  card     the device's name and power limit (nvidia-smi).
  build    nvcc builds every kernel source of the port (one process each, all
           at once) and prints the -Xptxas -v summary.
  kernels  each kernel against its plain PyTorch version at the paths'
           widths and batch sizes on planes of 2^24 rows: int32, f32 and
           bf16 as each kernel takes them; indices below 0 and at or beyond
           R; one-hot lanes of duplicate rows, set through the plane's flat
           view; 64-bit offsets (planes of 2^31 elements); the multi-plane
           set at 1, 2, 3, 4 and 8 planes with scalar and tensor values;
           the multi-plane gather at 1-4 planes (int32 with f32, bf16;
           widths 1, 32, 128, 256); the fetch-add (row_scatter_add with
           `old`: plane and old bits, int32 wrap, f32, widths 1, 32, 128).
           Bit-exact, except the segment sum (row_merge_add's kernels for
           duplicate rows), whose plain version adds with atomics: there
           within the bound of two f32 summation orders, and the kernels'
           bits equal on two calls. The segment sum also on one train
           step's dedup (with one id repeated 5,000 times more): runs of
           <= S updates (the kernel's segment size) bit-exact against the
           input-order sum, all runs within the order bound, the same bits
           on two calls and with the wrapper's own sort; under
           unique-capacity overflow too. The bag pool (segment_sum_gather,
           `check_segment_sum_gather`) at MLPerf DLRM-DCNv2's training
           shapes, forward and backward: two calls equal, runs of <= 2
           segments bit-exact against the plain version, the rest within
           the order bound, 4 launches a GatherRows forward and backward,
           and its times against the bytes bound. Then 3
           training steps on a 2^16-slot table on the card and on the CPU
           from one state: key, freq, last, cnt, ovf and counters equal;
           values, accumulators and loss within rtol 1e-5 / atol 1e-6;
           dense params within atol 1e-4. Then the bucket probe on the key
           planes of the benchmark's two filled tables
           (`time_bucket_probe`: every vocabulary id of
           benchmark/configs/dlrm-kaggle.json and dlrm-mlperf-tb.json
           through insert_rows at the configuration's capacity and probe
           rounds): on 8 training batches' worth of ids each (B x 26 ids,
           the share of unknown ids, padded), the kernel equal to the plain
           version bit for bit, slot and found; the share of found keys
           resolved in the first to fourth bucket of their walk; the
           kernel's call, device, plain and host times and its bytes bound.
  serve    the serving path, with the kernels' launch counters set to 0
           just before it: a one-shard checkpoint in the reference format
           (numpy, from --seed) restores into a ScoringService over a
           2^27-slot dim-32 table (rowwise AdaGrad, f32) with the default
           DLRM tower; `table.assign` fills it toward 100M live rows in
           batches of 65,536; 32 requests of 4096 x 26 one-hot ids (90%
           live, 10% unknown) are scored and timed; one request's rows are
           held against the rows that were written, its scores against the
           tower on the CPU, and one POST /score against the direct score.
           On the card a request of one size replays its CUDA graph
           (`ScoringService._graph_score`), which calls no kernel wrapper:
           fails unless the warm-up's capture counts twice an eager
           request's 1 bucket_probe and 2 row_gather (the values; the
           inverse), every timed request is a replay and counts none, and
           a traced replay runs those 3 launches.
           Right after the restore, before the fill, it makes the
           sharded_http phase's requests (5 warm-up and 32 timed of 4096 x
           26 ids of the checkpoint, 10% unknown, and one of 37 rows),
           scores them, keeps them and their scores in
           build/chip_smoke_http/, and times them as POST /score to its own
           HTTP server (each reply equal to the direct score).
  int8     with the counters set to 0 just before it, on the serve phase's
           checkpoint (8,388,608 rows, dim 32): an int8 ScoringService
           (QuantizedTable.from_checkpoint); the 2^20 kept rows read back
           within range/510 (half a code step) + an ulp of the range + an
           ulp of the row's largest magnitude (the dequantizer's two
           roundings; ids up to 2^62), unknown ids read zeros; 32 requests of 4096 x 26 ids
           of the checkpoint (10% unknown) timed, their scores' largest gap
           to the f32 service logged (and on the serve phase's requests,
           whose assigned ids the checkpoint lacks), one POST /score equal
           to the direct score; nbytes against the f32 state. Fails unless
           a request launches 2 row_gather and the phase nothing else.
  sharded  the row-sharded layer, with the counters set to 0 just before it,
           on a world of one (a process group of backend "cpu:gloo,cuda:nccl":
           NCCL for the card's tensors) with FORCE_EXCHANGE on, so the full
           route -> all-to-all -> owner re-dedup -> lookup -> way back path
           runs over NCCL. (a) A ShardedTrainer takes 3 steps of 512 x 26 ids
           on a 2^16-slot table on the card and on the CPU from one state
           (the tower held still, as the zoo's two-tower parity holds it),
           for the dense and the ragged exchange: integer planes and
           counters (route drops too) equal, values, accumulators and loss
           within rtol 1e-5 / atol 1e-6, dense params within atol 1e-4. (b)
           Config 2's width (dim 32, f32, rowwise AdaGrad, the default DLRM,
           4096 x 26 ids a step from SyntheticStream) on a fresh 2^26-slot
           table (9.3 GiB) for each of three exchanges: the fast path
           (FORCE_EXCHANGE off: the single-device step), the dense exchange
           and the ragged one, 5 warm-up + 30 timed steps each (the part to
           cut first if the script outgrows its time), then 4 profiled
           steps. Step p50/p99, examples/s, ids/s, drops and route drops (0
           at a world of one), first and last loss; the forced exchanges'
           p50 over the fast path's is the card's exchange tax at S = 1.
           Fails on a non-finite loss, a drop, or other launches a step than
           these, derived from the train phase's (1 set, 1 row_scatter_add,
           3 K1, 1 bucket_probe, 2 row_gather + 1 a planning round): the
           fast path launches the train phase's; the dense exchange adds the
           owner side's gather of its rows by its dedup inverse, the source
           side's gather of the rows that come back, and the 2 K1 of the
           owner's segment sum of the received gradients: 1 set, 1
           row_scatter_add, 5 K1, 1 bucket_probe, 4 row_gather + 1 a round;
           the ragged exchange places the returning rows by a scatter (no
           kernel): 3 row_gather + 1 a round, the rest as the dense. (c) A
           ShardedScoringService restores the serve checkpoint (8,388,608
           rows) into a 2^24-slot shard; 32 requests of 4096 x 26 of its ids
           (10% unknown) are timed, each failing unless it launches 1
           bucket_probe and 3 row_gather (a single-device request's 2 plus
           the returning rows' gather) and nothing else, and unless its
           scores equal an f32 ScoringService's on the same checkpoint within rtol
           1e-6; one POST /score equals the direct score. (d) At reduced
           depth (2^20 slots): 12 steps with LFU/TTL eviction into a
           HostKVStore every 4 (evicted == spilled), promotion of spilled ids
           back through maintenance() (rows equal their payload bit for
           bit), `remove` through exchange_erase, growth of a grow_at_load
           table (every earlier row kept; those the growing step did not
           touch bit for bit), and save_checkpoint over the multi-process
           protocol, restored into a ShardedTrainer and into a Trainer with
           every row and dense leaf equal. The process group is destroyed at
           the end of the phase.
  colsharded  README's wide table (dim 256) on a 1 x 2 grid
           (`ColShardedTrainer`, `make_mesh2d`): two rank processes of this
           script (`--col-rank`) on the one card in a gloo group (NCCL
           refuses two ranks on one device; at S = 1 no all-to-all runs, so
           the collectives are gloo's CUDA all_gather, all_reduce and
           broadcast, staged through the host). ctr_mlp (13 dense, 26
           sparse, top 256-128-1), batches of 4096, rowwise AdaGrad. (a) A
           small copy (2^16 slots, 3 of the same batches): the grid's
           losses and merged rows within rtol 2e-3 / atol 2e-4 of a
           single-device Trainer's on the card, and its 2-D checkpoint
           restored into a Trainer with every row, freq and accumulator
           bit-equal. (b) The main path, each rank with its counters set
           to 0 just before it: 2^24 slots a rank (8 GiB of values; cut
           from a deployment's capacity), LFU/TTL with a HostKVStore on
           column 0; 5 + 30 timed steps, failing unless a step launches the
           lifecycle's (2 sets, 2 row_scatter_add, 3 K1, 1 bucket_probe, 2
           gathers + 1 a planning round); 4 more steps with the column
           collectives timed
           apart (their share of a step); an eviction pass (3 gathers, 2
           sets; column 0 spills full-dim rows, as many as evicted);
           spilled ids trained again and promoted back, their full rows
           (blocks all-gathered) and accumulators equal to the payloads bit
           for bit. Fails on drops or route drops, and unless the key
           planes, cnt, ovf, freq, last, the accumulator and the counters
           hash the same on both ranks. Each rank prints its launches and
           times as a JSON line, which this process reads.
  train    the training path, with the counters set to 0 just before it: a
           Trainer with the default DLRM (tower from --seed) on the same
           table (2^27 slots, ~100M rows, dim 32, f32, rowwise AdaGrad)
           takes 5 warm-up and 30 timed steps of 4096 x 26 one-hot ids from
           the port's SyntheticStream (Zipf a = 1.2, seeded); ids new to the
           table, so early steps insert at load 0.745 and later ones mix
           hits with inserts. Step p50/p99, examples/s, ids/s, unique ids,
           hits, inserts and drops, first and last loss, launches per step;
           fails on a non-finite loss, drops above 1% of inserts, or other
           than 1 row_scatter_set, 1 row_scatter_add (the accumulator's
           fetch-add), 3 row_merge_add (the values update; the segment
           sum's walk and combine pass) and 1 bucket_probe launches a step,
           or other than 2 row_gather a step (the values, the inverse)
           plus 1 a planning round (counted by the
           `meepo.table.plan_round` spans entered; so no gather of the
           accumulator), or, in an
           assign batch, other than 3 row_scatter_set launches. Then
           torch.profiler over 4 steps.
  timing   each kernel with CUDA events on the live table's planes, at the
           main paths' shapes, beside its plain version, one library call
           and its memory bound (bytes / 3.35 TB/s, H100 SXM); then each
           kernel against its plain version on those inputs (writes on
           copies of the planes), whose largest difference is max_abs_err.
           Also the train step's and a restore batch's multi-plane sets
           (library: one index_put_ a plane), the bucket probe of a
           request's unique ids (no library call computes a probe), the
           key-plane gather of insert planning (library: one index_select a
           plane), the step's fetch-add (library: index_select +
           index_add_), the segment sum's walk and combine pass apart, a
           check that the step's valid slots are unique, the 32-byte-sector
           bound of the 4-byte-row shapes, and the host time of one call
           of every wrapper. The device time of a call and of its kernel
           comes from torch.profiler over a pass after a warm-up pass, kept
           only from a session that recorded every launch the wrappers made
           (else null), and null where it reads below the bytes bound; the
           values gather is also timed under the other ways of tracing
           (`profiler_methods`). Also the int8 lookup's two gathers (the codes'
           [N, 8] int32 view, the [N, 4] side plane) at 8 requests'
           positions, and, after the group phase, the user member's
           [2^24, 64] values gather and add and the FTRL item member's
           gather of z, n and values and its add into z, at a step's slots;
           then the column block's shapes: the values gather and add on a
           [2^24, 128] f32 plane and the gradient segment sum at 128 lanes,
           on the slots of one step of the colsharded phase's ids.
  profile  torch.profiler over 8 requests and 4 assign batches: wall time,
           device busy time and the heaviest ops of each.
  lifecycle  with the counters set to 0 just before it. (a) On the live
           table at full width: a Trainer with LFU (freq < 2) / TTL (20
           steps) eviction over windows of 2^15 of the 2^20 buckets, at
           most 2^14 rows a pass, into a HostKVStore spill tier, takes 40
           steps of 4096 x 26 ids with maintenance() every 5. Each pass's
           spilled payloads must equal, bit for bit, the rows the plain
           rule selects on a copy of the window taken just before it, and
           its ids probe absent; evicted == spilled == the store's rows;
           check_invariants all 0. Then `remove` of 65,536 assigned ids
           (count and erases equal the ids found before; none found after;
           invariants 0), and promotion of 4,096 spilled ids through a
           table's train lookups (rows equal their payload, promotes
           counted, gone from the store). A step must launch 2 sets, 2
           row_scatter_add, 3 row_merge_add, 1 bucket_probe and 2 + rounds
           row_gather; a pass 3 row_gather and 2 sets. (b) At reduced
           depth, same width:
           a Trainer on a 2^23-slot table filled to 6,000,000 rows saves
           async after 3 steps and streamed (parts of 2^22 rows) after 5;
           both restore with every row and dense leaf equal to the
           trainer's at the save's step; a grow_at_load=0.75 table of the
           same rows grows to 2^24 slots through a train lookup of 2^19 new
           ids, every earlier row kept. Then the lifecycle's new call
           shapes are timed as the timing phase times the others.
  zoo      with the counters set to 0 just before it. (a) 3 Trainer steps of
           ctr_mlp, dcn, deepfm, din, bst (bags of 5) and two_tower (logQ
           on) at the default ModelConfig widths on a 2^16-slot table, on
           the card and on the CPU from one state: planes and counters
           equal, values, accumulators, loss and logits within rtol 1e-5 /
           atol 1e-6 (two-tower margins: atol 1e-5 * tau), params within
           atol 1e-4. (b) 4096 x 35 Criteo-format lines with a planted
           signal (write_synthetic_criteo_signal: Zipf s = 1.05, 20,000
           values a feature) read by CriteoStream through PrefetchStream
           (depth 2), failing unless the native parser runs; ctr_mlp, dcn
           and deepfm each take 5 warm-up and 30 timed steps of 4096
           examples on the live table (config 2's width). (c) din and bst on
           SyntheticStream bags of 20 ids (4096 x 26 x 20 a step; the BST
           paper's sequence length) and two_tower with logQ on 4096 x 26
           one-hot ids, same table and step counts. Each kind: step p50 /
           p99, examples/s, ids/s, drops, first and last loss; fails on a
           non-finite loss, drops above 1% of inserts, or other launches a
           step than the train phase's. (d) the dcn and din trainers of (a)
           save a checkpoint that a ScoringService restores; one request's
           scores equal the trainer's eval_step logits through a sigmoid
           (rtol 1e-5).
  embed    with the counters set to 0 just before it. (a) 3 steps of a user
           model (logistic regression over the flattened embeddings, SGD)
           through embed.lookup / update on a 2^16-slot table, 512 x 26
           ids, on the card and on the CPU from one state: planes and
           counters equal, values and accumulators within rtol 1e-5 / atol
           1e-6. (b) 35 steps of 4096 x 26 ids on the live table, failing
           unless a step launches what a train step does.
  retrieval  with the counters set to 0 just before it: a two_tower (the
           zoo's config, logQ) trains 5 + 30 steps of 4096 examples on a
           fresh 2^23-slot table, saves, and restores into an f32 and an
           int8 ScoringService; for each, a RetrievalService builds an
           index of 2^20 items (25 item ids each: the 4 held-out batches'
           items, then ids drawn from the trained ids of each column),
           holds the top-100 of 8 queries against a brute-force f32 q @ V.T
           (scores within 1e-4, keys equal where ranks are more than 1e-4
           apart), times 30 requests of 256 queries at k = 100 and logs
           evaluate's recall@{1,10,100} on the held-out batches; POST
           /retrieve equals retrieve. Fails unless an index lookup or a
           request launches 1 bucket_probe and 2 row_gather (f32) or 2
           row_gather alone (int8). The f32
           service also answers one request over the corpus cut to its
           first 2^16 items, which the sharded_http phase holds its
           /retrieve to; the checkpoint stays for that phase.
  group    with the counters set to 0 just before it. (a) 3 GroupTrainer
           steps of 512 x 26 ids, card and CPU from one state, planes and
           counters equal. (b) A GroupTrainer at config 2's width (13 dense,
           26 sparse columns, ctr_mlp head 256-128-1) over user (dim 64,
           rowwise AdaGrad, 2^24 slots, column 0), item (dim 32, FTRL, 2^24
           slots, columns 1-2, one shared table) and ctx (dim 32, rowwise
           AdaGrad, 2^25 slots, columns 3-25) takes 5 + 30 steps of 4096
           examples, failing on drops, a non-finite loss, or other launches
           a step than each member's optimizer gives (`member_launches`).
           (c) At reduced depth (2^20-slot members): LFU/TTL eviction of
           user into a HostKVStore, promotion back (rows equal their
           payload), remove, growth of item at grow_at_load; then
           save_checkpoint restored into a GroupScoringService, whose scores
           equal the trainer's eval_step probabilities and POST /score.
  group_sharded  with the counters set to 0 just before it, on a world
           of one (NCCL) with FORCE_EXCHANGE, the group phase's members and
           widths through `ShardedGroupTrainer`. (a) 3 steps of 512 x 26
           ids on the card and on the CPU from one state, dense and ragged:
           planes and counters equal, losses within rtol 1e-5 / atol 1e-6.
           (b) 5 + 30 steps of 4096 examples at the group phase's
           capacities for each exchange, failing on drops, route drops, or
           other launches a step than each member's optimizer gives plus,
           a member, the owner's gather by its dedup inverse and the
           segment sum of the received gradients (2 K1) and, dense, the
           gather of the returning rows; step p50 beside GroupTrainer's.
           (c) At 2^20 slots a member, 5 steps: the sharded checkpoint
           restored into a GroupTrainer with every row equal, and
           GroupScoringService(distributed=True) against the single-device
           service on it: 32 requests of 4096 examples, scores within rtol
           1e-6, request p50 of both. The checkpoint and the single-device
           scores of its first request stay for the sharded_http phase.
  sharded_http  one HTTP front over S = 2 row-sharded ranks
           (`serving_sharded.LockstepFront`): two rank processes of this
           script (`--front-rank`) on the one card in a gloo group (NCCL
           refuses two ranks on one device; gloo stages the collectives,
           the exchange's all-to-alls among them, through the host, so this
           prices the front and not a wire). It runs last, when this
           process holds no table. Each rank sets its counters to 0 just
           before its main path. Rank 0 serves HTTP on a free port; this
           process is the client, and a line to rank 0's standard input
           stops each part (the stop op; both ranks must return 0). (a)
           The serve checkpoint (8,388,608 rows, dim 32) restored over the
           two ranks at config 2's capacity, 2^26 slots a rank (~2 x 9.3
           GiB): /healthz rows equal the checkpoint's; the serve phase's 5
           + 32 requests and the one of 37 rows, each reply equal to its
           single-device score (rtol 1e-5, atol 1e-6), the 32 timed (p50 /
           p99 beside the serve phase's single-device HTTP p50 / p99);
           /metrics shows 2 mesh devices and no route drops; a malformed
           body gets a 400 and the next request answers; /reload of the
           checkpoint keeps its rows; /reload of a missing path gets a 400
           and the scores stay the same. (b) The retrieval phase's
           two-tower over the two ranks; rank 0 builds a RetrievalService
           index of the corpus cut to 2^16 items through the front;
           /retrieve equals the single-device keys (scores within rtol
           1e-5, atol 1e-6). (c) The group_sharded phase's members (2^20
           slots) in a GroupScoringService(distributed=True) a rank; one
           request of 4096 examples equals the single-device scores. Fails
           unless every score or lookup call on a rank launches 1
           bucket_probe and 3 row_gather (the sharded phase's request: the
           values, the returning rows, the inverse; a group request that
           many a member) and nothing else.
  entry    the entry points (`meepoembedding_tpu_torch/entry.py`):
           `entry(device="cuda")`'s forward over the batch's rows (inserted
           from --seed) equals the same forward on the CPU through the
           plain versions (rtol 1e-5, atol 1e-6), failing unless it
           launches 1 bucket_probe and 2 row_gather and nothing else; then
           `dryrun_multichip(torch.cuda.device_count())`, a world of one
           over NCCL in a spawned process.
  cli      the command line (`python -m meepoembedding_tpu_torch`), in two
           parts, each with the counters set to 0 just before it. (a) Right
           after the kernel checks, where the script holds the least device
           memory: `train` from scratch in a subprocess through the module
           entry point at config 2's width (dim 32, 2^27 slots, the default
           DLRM, 5 + 30 steps of 4096 x 26 ids, --ckpt-dir), failing on a
           non-finite loss or drops above 1% of inserts (its mean step, read
           from its log, includes making each synthetic batch on the host,
           which is timed apart); in-process
           `ckpt-inspect` (its counts sum to the exported rows), `ckpt-export`
           (npz) and `ckpt-import` of that checkpoint (the imported rows equal
           the export bit for bit); `train --restore` of it for 5 steps;
           `eval` and `serve` of it on the card and on the CPU at 2^21 slots
           (examples equal, AUC within 1e-6, mean loss within rtol 1e-5,
           printed scores within rtol 1e-5 / atol 2e-6); `bench-lookup` and
           `bench-update` with --rows 1e8 --batch 524288 --steps 20, their
           JSON lines printed. (b) After the sharded phase, on the serve
           checkpoint (8,388,608 rows at 2^27 slots): `serve` of 32 batches of
           4096 synthetic examples, scores within rtol 1e-5 / atol 1.5e-6 of
           the serve phase's ScoringService on the same batches, and `eval` of
           8 of them, whose AUC (within 1e-6) and mean loss (rtol 1e-5) are
           those of that service's scores. Each in-process command is held to
           its launches: a restore batch 3 sets and 1 probe, a scoring
           batch 1 probe and 2 gathers (on the card, the batches' one
           size's graph capture twice that and its replays none), a train
           step the train phase's, an
           import chunk 3 sets and 1 probe and a saved part file 3 gathers,
           a bench prefill batch 3 sets and 1 probe and a bench cycle 1
           set, 1 probe and 2 gathers (+ 3 K1 and 1 fetch-add to update),
           and 1 gather a planning round; inspect and export launch
           nothing.

  harness  the measurement harnesses (`meepoembedding_tpu_torch/bench/`),
           each called in-process through its `run()` with the counters set
           to 0 just before it, its log relayed: the headline at config 2's
           width (2^27 slots, 107.4M live rows at fill 0.8, dim 32 f32,
           18.5 GiB of table state; batches of 2^19 ids, 20 steps a window),
           phases, stages and evict at the reference's sizes (2^25 slots;
           stages 2^22), ckpt_full at 2^25 slots bf16 (cut from 2^27: 8.4 GB
           on disk) under build/chip_smoke_harness/, removed at the end of
           the phase, serving and retrieval at the reference's sizes,
           sharded_overhead at its sizes with all four arms, scaling at S =
           1 (a rank process). Fails unless each JSON line has the
           reference's keys, the headline's dedup capacity held on every
           step (its drop rate logged), ckpt_full's sample is bit-exact,
           evict exported rows, sharded_overhead has no route drops, and
           each harness launched every kernel (retrieval none: it times the
           towers and the index only); the headline exactly the launches
           its steps give (`headline_launches`). Every kernel call of a
           harness goes through `held_kernels`: the first at each set of
           planes and power-of-two size class of n is held against the
           plain version on the same inputs (bit-exact, in-place calls on a
           copy of their rows, which must be unique; the segment sum within
           the summation-order bound), so the headline's dynamic cycle at
           2^27, evict's exports and clears, ckpt_full's bf16 chunks and
           restore sets and every other harness's shapes are checked in the
           run that times them (scaling's rank 0 at S = 1 once more in this
           process, as the hold cannot reach its rank process; retrieval
           launches nothing). Then one cycle of each
           static arm (the headline's two, phases' library arm) on a [2^27,
           32] f32 plane against the plain versions on the CPU, within the
           summation-order bound, and `python -m
           meepoembedding_tpu_torch.bench.headline` in a subprocess at 2^20
           slots, its last line parsed.
  dma      the random-row copy probe's kernels, K6 and K7
           (`row_block_gather`, `row_block_scatter`; nothing launches them
           before this phase, whose first act is to read their counters:
           0). Each against its plain version, bit for bit, at every (R, W)
           of bench_dma.py's sweeps (gather R 1-32 x W 8-256, scatter R 1,
           4, 16 x W 32, 256; W capped at the ring that fits a block) on a
           [2^22, 128] f32 plane with 2^16 descriptors: the gather's bases
           random with the clip edge in front, every W giving the same
           bits; the scatter's random rows into disjoint blocks, clipped at
           both ends; then a ring that does not fit must be refused. Then,
           with every counter set to 0 just before them, `bench.dma`,
           `bench.row_kernels` and `bench.dedup_variants` at their defaults
           in-process, their logs relayed and JSON lines logged, their
           kernel calls held against the plain versions (`held_kernels`;
           K6 / K7 once at each (R, W) on bench.dma's own stream, the
           scatter's shared rows each holding one of its writers' rows),
           failing where a harness launched a kernel and held none; fails
           unless bench.dma's line has its keys, 14 capped rings and a
           blocks-per-SM figure at every point, and the path launched K6,
           K7, row_gather, row_scatter_add and row_scatter_set. Then each
           sweep point timed on bench.dma's stream (`time_dma_kernels`):
           kernel, plain, library (R = 1), bound, and the profiler's device
           time at R = 1, W = 32, the kernels line's main point.

The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}. `--rehearse-on-cpu` runs every
phase but the kernel checks and timings on the CPU at the sizes given (the
sharded phase on a gloo world of one, its tables at --capacity slots; the
lifecycle's reduced-depth table at 2^14 slots; the zoo and embed phases on
a fresh table of --capacity slots, bags of 4, 1 + 2 steps; a 2^12-item
index; 2^12- to 2^14-slot group members; the cli phase's train, restore
and bench at --capacity slots and --batch examples, 1 + 2 steps; the
colsharded ranks on the CPU at --capacity slots; the sharded groups at
2^12- to 2^13-slot members; the sharded_http ranks on the CPU at --capacity
slots; the entry's dry run on one gloo rank; the harnesses at --capacity
slots and a few steps, no static-arm check; the dma phase's checks and
harnesses on a [4096, 128] plane, no timing) with the plain versions and,
with torch held to one thread in every process it starts, exits 1 without
a result: a dry run of the control flow on machines without a card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import gc
import hashlib
import inspect
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from meepoembedding_tpu_torch import (
    ModelConfig,
    OptimizerConfig,
    ScoringService,
    TableConfig,
    cli,
    embed,
    make_http_server,
    tracing,
)
from meepoembedding_tpu_torch import checkpoint as ckpt_io
from meepoembedding_tpu_torch.backends import HostKVStore
from meepoembedding_tpu_torch.checkpoint import export_shard_arrays, load_dense
from meepoembedding_tpu_torch.config import LANES, PolicyConfig, RunConfig
from meepoembedding_tpu_torch.data import (
    CriteoStream,
    PrefetchStream,
    SyntheticConfig,
    SyntheticStream,
)
from meepoembedding_tpu_torch.data.criteo import write_synthetic_criteo_signal
from meepoembedding_tpu_torch.metrics import StreamingAUC
from meepoembedding_tpu_torch.group_train import GroupTrainer, ShardedGroupTrainer
from meepoembedding_tpu_torch.kernels import (
    _build,
    bucket_probe,
    bucket_probe_plain,
    row_block_gather,
    row_block_gather_plain,
    row_block_scatter,
    row_block_scatter_plain,
    row_gather,
    row_gather_multi,
    row_gather_multi_plain,
    row_gather_plain,
    row_merge_add,
    row_merge_add_plain,
    row_scatter_add,
    row_scatter_add_plain,
    row_scatter_set,
    row_scatter_set_multi,
    row_scatter_set_multi_plain,
    row_scatter_set_plain,
    segment_size,
    segment_sum,
)
from meepoembedding_tpu_torch.kernels.row_block_copy import block_rows
from meepoembedding_tpu_torch.ops import dedup
from meepoembedding_tpu_torch.parallel import mesh as pmesh
from meepoembedding_tpu_torch.parallel import multihost
from meepoembedding_tpu_torch.parallel import sharded_table as st
from meepoembedding_tpu_torch.parallel.colsharded import ColShardedTrainer
from meepoembedding_tpu_torch.parallel.mesh import make_mesh
from meepoembedding_tpu_torch.parallel.trainer import ShardedTrainer
from meepoembedding_tpu_torch.retrieval import RetrievalService
from meepoembedding_tpu_torch.serving_sharded import LockstepFront, ShardedScoringService
from meepoembedding_tpu_torch.serving_group import GroupScoringService
from meepoembedding_tpu_torch.table import hashing, table_ops
from meepoembedding_tpu_torch.table.layout import TableSpec, alloc_shard
from meepoembedding_tpu_torch.table.runtime import DynamicEmbeddingTable
from meepoembedding_tpu_torch.tiering import SpillCodec
from meepoembedding_tpu_torch.train import Trainer
from meepoembedding_tpu_torch.weights import to_jax_adam_state, to_jax_params

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
CHECK_ROWS_LOG2 = 24  # rows of the planes of the kernel checks
TRAIN_BATCH, TRAIN_STEPS = 4096, 30  # examples per train step, timed steps on the card
STEP_IDS = TRAIN_BATCH * 26  # ids of one train step: its unique ids fit in it


def log(msg: str) -> None:
    print(msg, flush=True)


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--capacity", type=int, default=1 << 27)
    p.add_argument("--fill-rows", type=int, default=100_000_000)
    p.add_argument("--ckpt-rows", type=int, default=1 << 23, help="rows in the checkpoint")
    p.add_argument("--part-rows", type=int, default=1 << 22, help="rows per part file")
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--batch", type=int, default=4096,
                   help="examples per request (and per train step in a rehearsal)")
    p.add_argument("--rehearse-on-cpu", action="store_true")
    p.add_argument("--col-rank", type=int, default=None,
                   help="run one rank of the colsharded phase (the phase starts them)")
    p.add_argument("--col-dir", default=None, help="the colsharded ranks' meeting directory")
    p.add_argument("--front-rank", type=int, default=None,
                   help="run one rank of the sharded_http phase (the phase starts them)")
    p.add_argument("--front-dir", default=None, help="the sharded_http ranks' meeting directory")
    return p.parse_args()


def cap_cpu_threads() -> None:
    """A rehearsal runs beside other work on the CPU: one torch thread here
    and, through the environment, in every process it starts (the rank
    processes, the command line's subprocesses)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --- checkpoint in the reference format ---------------------------------------

def write_checkpoint(path: Path, rng, rows: int, part_rows: int, dim: int,
                     capacity: int, model_cfg, keep: int) -> dict:
    """A one-shard checkpoint as the JAX package writes it: streamed part
    files, a counters sidecar, dense-params.npz and the manifest last.
    Returns all ids and the values of the first `keep` rows."""
    step = 1000
    gen = f"step-{step}"
    gdir = path / gen
    gdir.mkdir(parents=True)
    ids = rng.integers(1, 2**62, size=rows, dtype=np.int64)
    kept = []
    for p, o in enumerate(range(0, rows, part_rows)):
        n = min(part_rows, rows - o)
        # trained rows are small: the table initialises them at scale 0.01
        values = rng.standard_normal((n, dim), dtype=np.float32) * np.float32(0.05)
        kept.append(values[: max(0, keep - o)].copy())
        np.savez(
            gdir / f"shard-00000.part{p:04d}.npz",
            ids=ids[o:o + n],
            values=values,
            freq=rng.integers(1, 100, size=n, dtype=np.int32),
            last=rng.integers(0, step, size=n, dtype=np.int32),
            accum=rng.random(n, dtype=np.float32),
            n_live=np.int64(rows), chunk_rows=np.int64(part_rows), row_off=np.int64(o),
        )
    counters = np.zeros(16, np.int32)
    counters[:4] = [5_000_000, 1_000_000, rows, 0]  # hits, misses, inserts, drops
    np.save(gdir / "shard-00000.counters.npy", counters)
    leaves = []
    d = model_cfg.num_dense_features
    for h in model_cfg.bottom_mlp:
        leaves += [rng.standard_normal((d, h), dtype=np.float32) * np.sqrt(2.0 / d),
                   rng.standard_normal(h, dtype=np.float32) * 0.01]
        d = h
    f = model_cfg.num_sparse_features + 1
    d = model_cfg.embedding_dim + f * (f - 1) // 2
    for h in model_cfg.top_mlp:
        leaves += [rng.standard_normal((d, h), dtype=np.float32) * np.sqrt(2.0 / d),
                   rng.standard_normal(h, dtype=np.float32) * 0.01]
        d = h
    np.savez(gdir / "dense-params.npz", **{f"leaf{j}": x for j, x in enumerate(leaves)})
    manifest = {
        "format": 1, "num_shards": 1, "dim": dim, "capacity_per_shard": capacity,
        "step": step, "value_dtype": "float32",
        "optimizer": {"kind": "rowwise_adagrad", "rowwise_slots": 1, "fulldim_slots": 0},
        "counts": [rows], "dir": gen, "dense": ["params"], "extras": {},
        "counters": [int(x) for x in counters],
    }
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return {"ids": ids, "values": np.concatenate(kept)}


# --- kernel checks -------------------------------------------------------------

def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _onehot_dup_elements(R, n, width, copies, g, dev):
    """n int32 indices into the flat [R * width] view of an [R, width] plane:
    rows repeated `copies` times with one distinct lane each (the one-hot
    writes of duplicate bucket rows), elements of the plane's last rows, and
    indices below 0 and (where int32 holds them) at or beyond R * width."""
    base = torch.randperm(R // 2, device=dev, generator=g)[: n // copies]
    j = torch.arange(n, device=dev)
    span = width // copies
    lane = (j % copies) * span + torch.randint(0, span, (n,), device=dev, generator=g)
    idx = base[j // copies] * width + lane
    top = idx[1::97]
    top.copy_(R * width - 1 - torch.arange(top.shape[0], device=dev))
    idx[2::89] = -1 - torch.arange(idx[2::89].shape[0], device=dev)
    if R * width + n < 2**31:
        idx[3::83] = R * width + torch.arange(idx[3::83].shape[0], device=dev)
    return idx.to(torch.int32)


def check_kernels(rows_log2: int, seed: int) -> None:
    """Each kernel against its plain version; raises unless bit-exact."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    R = 1 << rows_log2

    def gather_case(name, plane, n):
        idx = torch.randint(0, plane.shape[0], (n,), device=dev, dtype=torch.int32, generator=g)
        idx[::101] = -3
        if plane.shape[0] + 7 < 2**31:  # int32 indices at or beyond R, where they fit
            idx[1::103] = plane.shape[0] + 7
        idx[2::107] = plane.shape[0] - 1
        got = row_gather(plane, idx)
        want = row_gather_plain(plane, idx)
        torch.cuda.synchronize()
        exact = torch.equal(_bits(got), _bits(want))
        log(f"check row_gather {name}: plane {tuple(plane.shape)} {plane.dtype}, n={n}: "
            f"{'bit-exact' if exact else 'MISMATCH'}")
        if not exact:
            raise AssertionError(f"row_gather {name} disagrees with its plain version")

    def set_case(name, plane, idx, upd):
        want = plane.clone()
        row_scatter_set(plane, idx, upd)
        row_scatter_set_plain(want, idx, upd)
        torch.cuda.synchronize()
        exact = torch.equal(_bits(plane), _bits(want))
        log(f"check row_scatter_set {name}: plane {tuple(plane.shape)} {plane.dtype}, "
            f"n={idx.shape[0]}: {'bit-exact' if exact else 'MISMATCH'}")
        if not exact:
            raise AssertionError(f"row_scatter_set {name} disagrees with its plain version")

    # int32: the key-pair gather of the probe ([nb/2, 256]) and the bucket
    # gather of insert planning ([nb, 128]), on one buffer of R x 256
    keys = torch.randint(-(2**31), 2**31 - 1, (R, 256), device=dev, dtype=torch.int32,
                         generator=g)
    gather_case("key pairs", keys, 1 << 17)
    gather_case("key buckets", keys.view(2 * R, 128), 1 << 16)
    del keys
    vals = torch.randn((R, 32), device=dev, generator=g)
    gather_case("values f32", vals, 1 << 17)
    gather_case("values bf16", vals.to(torch.bfloat16), 1 << 17)

    n = 1 << 16  # one restore / assign batch
    # one-hot lanes of duplicate rows into an [R, 128] int32 and f32 plane,
    # as elements of its flat [R * 128, 1] view (2^31 elements)
    plane = torch.randint(-(2**31), 2**31 - 1, (R, 128), device=dev, dtype=torch.int32,
                          generator=g)
    idx = _onehot_dup_elements(R, n, 128, 8, g, dev)
    upd = torch.randint(-(2**31), 2**31 - 1, (n, 1), device=dev, dtype=torch.int32,
                        generator=g)
    set_case("key plane int32 one-hot", plane.view(-1, 1), idx, upd)
    plane.view(torch.float32).normal_(generator=g)
    # the rowwise accumulator read of a train step: one f32 element per slot
    # of the flat view (4-byte rows)
    gather_case("accum elements f32", plane.view(torch.float32).view(-1, 1), STEP_IDS)
    set_case("accum plane f32 one-hot", plane.view(torch.float32).view(-1, 1), idx,
             torch.randn((n, 1), device=dev, generator=g))
    del plane
    # whole rows and one-hot lanes into [R, 32] value planes
    idx = (torch.randperm(R + 64, device=dev, generator=g)[:n] - 32).to(torch.int32)
    set_case("values f32 rows", vals, idx, torch.randn((n, 32), device=dev, generator=g))
    vb = vals.to(torch.bfloat16)
    idx = _onehot_dup_elements(R, n, 32, 4, g, dev)
    set_case("values bf16 one-hot", vb.view(-1, 1), idx,
             torch.randn((n, 1), device=dev, generator=g).to(torch.bfloat16))
    del vals, vb
    torch.cuda.empty_cache()
    check_multi_set(g, dev)
    check_gather_multi(rows_log2, g, dev)


def check_gather_multi(rows_log2: int, g, dev) -> None:
    """row_gather_multi against one plain gather a plane at K = 1-4
    planes of 2^24 rows (width 1: 2^31 rows, the flat view of [2^24, 128]
    planes), int32 and f32 planes together, then bf16; n not a multiple of 4
    (the 4-byte rows' tail); indices below 0, at or beyond R where int32
    holds them, and R - 1 (64-bit offsets). The K planes are views of one
    buffer at different row offsets. Bit-exact."""
    n = (1 << 17) + 3
    for width in (1, 32, 128, 256):
        R = (1 << rows_log2) * (128 if width == 1 else 1)
        for esize in (4, 2):
            dtype = torch.float32 if esize == 4 else torch.bfloat16
            buf = torch.randn(((R + 3) * width,), device=dev, dtype=dtype, generator=g)

            def plane(p):
                b = buf.view(torch.int32) if esize == 4 and p % 2 else buf
                return b[p * width:(p + R) * width].view(R, width)

            idx = torch.randint(0, R, (n,), device=dev, dtype=torch.int32, generator=g)
            idx[::101] = -3
            if R + 7 < 2**31:
                idx[1::103] = R + 7
            idx[2::107] = R - 1
            for k in (1, 2, 3, 4):
                planes = [plane(p) for p in range(k)]
                got = row_gather_multi(planes, idx)
                want = row_gather_multi_plain(planes, idx)
                torch.cuda.synchronize()
                if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want)):
                    raise AssertionError(f"row_gather_multi K={k} [{R}, {width}] {dtype} "
                                         f"disagrees with its plain version")
                del got, want
            log(f"check row_gather_multi: K = 1-4 planes [{R}, {width}] "
                f"{'int32 + f32' if esize == 4 else 'bf16'}, n={n}: bit-exact")
            del buf
            torch.cuda.empty_cache()


def check_multi_set(g, dev) -> None:
    """row_scatter_set_multi against its plain version (one plain set a
    plane) at K = 1, 4 and 8 planes: the train step's four bucket planes
    (two tensors, two scalars), eight int32 and f32 planes of mixed values,
    and whole rows of three [R, 32] planes with a scalar 0, as a restore
    batch sets the values and full-dim planes. Bit-exact."""
    nb, n = 1 << 20, 1 << 16

    def case(name, planes, idx, values):
        want = [p.clone() for p in planes]
        row_scatter_set_multi(planes, idx, values)
        row_scatter_set_multi_plain(want, idx, values)
        torch.cuda.synchronize()
        exact = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(planes, want))
        log(f"check row_scatter_set_multi {name}: K={len(planes)} planes "
            f"{tuple(planes[0].shape)}, n={n}: {'bit-exact' if exact else 'MISMATCH'}")
        if not exact:
            raise AssertionError(f"row_scatter_set_multi {name} disagrees with its plain version")

    def ints(shape):
        return torch.randint(-(2**31), 2**31 - 1, shape, device=dev, dtype=torch.int32,
                             generator=g)

    idx = _onehot_dup_elements(nb, n, 128, 8, g, dev)
    planes = [ints((nb, 128)) for _ in range(8)]
    for p in planes[4:]:
        p.view(torch.float32).normal_(generator=g)
    flat = [p.view(-1, 1) if i < 4 else p.view(torch.float32).view(-1, 1)
            for i, p in enumerate(planes)]
    case("one plane, tensor", flat[:1], idx, [ints((n, 1))])
    case("train step (key_hi, key_lo, freq = 1, last = step)", flat[:4], idx,
         [ints((n, 1)), ints((n, 1)), 1, 123456])
    case("int32 and f32, scalars and tensors", flat, idx,
         [ints((n, 1)), -7, ints((n, 1)), 2**31 + 5, torch.randn((n, 1), device=dev,
                                                                  generator=g),
          0.1, -0.0, torch.randn((n, 1), device=dev, generator=g)])
    del planes, flat
    rows = [torch.randn((nb, 32), device=dev, generator=g) for _ in range(3)]
    idx = (torch.randperm(nb + 64, device=dev, generator=g)[:n] - 32).to(torch.int32)
    case("whole rows (values, two full-dim planes = 0)", rows, idx,
         [torch.randn((n, 32), device=dev, generator=g), 0, 0.0])
    case("whole rows bf16", [r.to(torch.bfloat16) for r in rows[:2]], idx,
         [torch.randn((n, 32), device=dev, generator=g).to(torch.bfloat16), 0.5])
    del rows
    torch.cuda.empty_cache()


def order_bound(base, vrow, upd):
    """Per element, the most two f32 sums of the same terms in different
    orders can differ by: 2 * k * 2^-24 * (|old| + sum |upd|) for a row with
    k updates (the error bound of recursive summation, for each order)."""
    absum = base.float().abs()
    row_merge_add_plain(absum, vrow, upd.abs())
    ok = (vrow >= 0) & (vrow < base.shape[0])
    k = torch.zeros(base.shape[0], device=base.device)
    k.index_add_(0, vrow[ok].long(), torch.ones_like(vrow[ok], dtype=torch.float32))
    return 2 * (k + 1)[:, None] * 2**-24 * absum


def within_order_bound(got, want, bound) -> float:
    """Largest |got - want|; raises where it exceeds `bound` (plus one bf16
    unit in the last place, at most 2^-7 of the value, on bf16 planes)."""
    if got.dtype == torch.bfloat16:
        bound = bound + want.float().abs() * 2**-7
    err = (got.float() - want.float()).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"row_merge_add exceeds the summation-order bound by "
                             f"{float((err - bound).max())}")
    return float(err.max())


def check_add_kernels(rows_log2: int, seed: int) -> None:
    """row_scatter_add (K3), row_merge_add (K1's unique-row add) and
    segment_sum (K1's duplicate rows) against their plain versions; raises
    unless bit-exact where the plain version is exact."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    R = 1 << rows_log2
    n = 1 << 17  # the unique ids of one 4096 x 26 step fit in it

    def exact(name, got, want):
        ok = torch.equal(_bits(got), _bits(want))
        log(f"check {name}: {'bit-exact' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")

    # K3, whole rows of an [R, 128] int32 and f32 plane and of its
    # [4R, 32] view (unique rows, some below 0 and at or beyond R), then
    # elements of its flat [R * 128, 1] view (2^31 elements), as the
    # bucket-plane adds use it; each as the plain add and as the fetch-add
    # (plane and `old` bits)
    plane = torch.randint(-(2**31), 2**31 - 1, (R, 128), device=dev, dtype=torch.int32,
                          generator=g)
    rows = (torch.randperm(R + 64, device=dev, generator=g)[:n // 16] - 32).to(torch.int32)
    rows32 = (torch.randperm(4 * R + 64, device=dev, generator=g)[:n // 4 + 1] - 32).to(
        torch.int32)
    flat = _onehot_dup_elements(R, n, 128, 8, g, dev)[:-1]  # odd n: the elements' tail
    for dtype in (torch.int32, torch.float32):
        p = plane if dtype == torch.int32 else plane.view(torch.float32).normal_(generator=g)
        for what, view, idx in (("rows", p, rows), ("rows", p.view(-1, 32), rows32),
                                ("flat view", p.view(-1, 1), flat)):
            if dtype == torch.int32:
                upd = torch.randint(-(2**31), 2**31 - 1, (idx.shape[0], view.shape[1]),
                                    device=dev, dtype=dtype, generator=g)
            else:
                upd = torch.randn((idx.shape[0], view.shape[1]), device=dev, generator=g)
            for fetch in (False, True):
                want = view.clone()
                old = torch.full_like(upd, 5) if fetch else None
                want_old = torch.empty_like(upd) if fetch else None
                row_scatter_add(view, idx, upd, old)
                row_scatter_add_plain(want, idx, upd, want_old)
                torch.cuda.synchronize()
                name = (f"row_scatter_add{' fetch-add' if fetch else ''} {what} "
                        f"{tuple(view.shape)} {dtype}, n={idx.shape[0]}")
                exact(name, view, want)
                if fetch:
                    exact(f"{name}: old", old, want_old)
                del want, old, want_old

    # K1, unique rows (the values update): bit-exact on the [R, 128] f32
    # plane (64-bit offsets) and on [R, 32] f32 and bf16 value planes
    fp = plane.view(torch.float32)
    urow = (torch.randperm(R + 64, device=dev, generator=g)[:n] - 32).to(torch.int32)
    upd = torch.randn((n, 128), device=dev, generator=g) * 1e-3
    want = fp.clone()
    row_merge_add(fp, urow, upd)
    row_merge_add_plain(want, urow, upd)
    torch.cuda.synchronize()
    exact(f"row_merge_add unique rows {tuple(fp.shape)} f32, n={n}", fp, want)
    del plane, fp, want
    torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        base = torch.randn((R, 32), device=dev, generator=g).to(dtype)
        upd = torch.randn((n, 32), device=dev, generator=g) * 1e-3
        got, want = base.clone(), base.clone()
        row_merge_add(got, urow, upd)
        row_merge_add_plain(want, urow, upd)
        torch.cuda.synchronize()
        exact(f"row_merge_add unique rows {tuple(base.shape)} {dtype}, n={n}", got, want)
        del base, got, want
    # duplicate rows (the gradient segment sum: a Zipf head repeats ids
    # hundreds of times) into an [R, 32] f32 output, drops below 0 and at or
    # beyond R
    m = STEP_IDS
    vrow = torch.randint(0, R, (m,), device=dev, generator=g)
    hot = torch.randint(0, R, (16,), device=dev, generator=g)
    pick = torch.rand((m,), device=dev, generator=g) < 0.4
    vrow = torch.where(pick, hot[torch.randint(0, 16, (m,), device=dev, generator=g)], vrow)
    vrow[::97] = -1
    vrow[1::89] = R + 3
    vrow = vrow.to(torch.int32)
    upd = torch.randn((m, 32), device=dev, generator=g)
    first = segment_sum(upd, vrow, R)
    again = segment_sum(upd, vrow, R)
    zero = torch.zeros((R, 32), device=dev)
    want = row_merge_add_plain(zero.clone(), vrow, upd)
    torch.cuda.synchronize()
    exact("segment_sum duplicate rows, call against call", first, again)
    err = within_order_bound(first, want, order_bound(zero, vrow, upd))
    log(f"check segment_sum duplicate rows [{m}, 32] -> [{R}, 32] f32: "
        f"max |kernel - plain| {err} within the summation-order bound")
    del first, again, zero, want
    torch.cuda.empty_cache()


def check_segment_sum(seed: int) -> None:
    """segment_sum (K1's duplicate rows, summed from zero) on the dedup of
    one train step's ids (4096 x 26, Zipf) with one id set at 5,000 more
    positions: the same bits on two calls and when the wrapper sorts for
    itself; runs of at most S updates (the kernel's segment size) bit-exact
    against the input-order sum (the plain version on the CPU); every run
    within the summation-order bound. Then with the unique capacity
    overflowed (aliased ids share the last run, in id order): two calls
    equal and within the bound."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 23)
    batch = next(iter(SyntheticStream(SyntheticConfig(batch_size=TRAIN_BATCH,
                                                      seed=seed + 19)).batches(1)))
    ids = torch.from_numpy(batch["ids"]).to(dev).reshape(-1)
    n = ids.shape[0]
    ids[torch.randperm(n, device=dev, generator=g)[:5000]] = ids[7].clone()
    hi, lo = hashing.split_ids_t(ids)
    grads = torch.randn((n, 32), device=dev, generator=g)
    S = segment_size()
    for size in (n, 20_000):
        u = dedup.unique_pairs(hi, lo, size)
        U, inv = u.hi.shape[0], u.inverse
        want = row_merge_add_plain(torch.zeros((U, 32)), inv.cpu(), grads.cpu()).to(dev)
        bound = order_bound(torch.zeros((U, 32), device=dev), inv, grads)
        runs = torch.bincount(inv.long(), minlength=U)
        got = segment_sum(grads, inv, U, u.order, u.sorted_ids)
        again = segment_sum(grads, inv, U, u.order, u.sorted_ids)
        torch.cuda.synchronize()
        if not torch.equal(_bits(got), _bits(again)):
            raise AssertionError("segment_sum: two calls gave different bits")
        what = f"segment_sum S={S}, [{n}, 32] -> [{U}, 32], longest run {int(runs.max())}"
        if size == n:
            if not torch.equal(_bits(got), _bits(segment_sum(grads, inv, U))):
                raise AssertionError(f"{what}: the dedup's sort and the wrapper's differ")
            short = runs <= S
            if not torch.equal(_bits(got[short]), _bits(want[short])):
                raise AssertionError(f"{what}: runs of <= S updates differ from "
                                     f"the input-order sum")
            what += f": {int(short.sum())} rows of <= S updates bit-exact"
        else:
            what += " (unique capacity overflowed)"
        err = within_order_bound(got, want, bound)
        log(f"check {what}; max |kernel - plain| {err} within the order bound")
    torch.cuda.empty_cache()


# MLPerf DLRM-DCNv2's training step: 8192 examples of 26 bags of these sizes
DCNV2_SIZES = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1)
DCNV2_BATCH, DCNV2_DIM = 8192, 128


def check_segment_sum_gather(seed: int) -> list:
    """segment_sum_gather, the bag pool of `dedup.GatherRows` (K1's walk and
    combine reading rows through an index), at MLPerf DLRM-DCNv2's training
    shapes: 8192 x 26 bags of DCNV2_SIZES ids (1,753,088 a step, each bag a
    Zipf(1.05) head and fixed ids of it, as the benchmark's traffic makes
    them), deduplicated at capacity n, dim 128. Forward (the unique rows
    into the bags) and backward (the bags' gradient into the unique rows,
    the dedup's sort): the same bits on two calls, bit for bit equal to the
    plain version on the CPU on every output row whose run touches at most
    two segments, the others within the summation-order bound. One
    GatherRows forward and backward with the counters set to 0 just before
    launches 4 row_merge_add and nothing else. Returns the two timing
    records; the bounds read each id's 12 bytes of index, each distinct
    source row once and write every output row (the backward's [n, 128]
    output whole: the rows past the unique count are the memset's)."""
    from meepoembedding_tpu_torch.kernels import segment_sum_gather
    from meepoembedding_tpu_torch.ops import pooling

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 29)
    g = torch.Generator(device=dev).manual_seed(seed + 29)
    B, D, S = DCNV2_BATCH, DCNV2_DIM, segment_size()
    cards = json.loads((ROOT / "benchmark" / "configs" / "dlrm-dcnv2.json").read_text())[
        "cardinalities"]
    cols = []
    for f, (size, card) in enumerate(zip(DCNV2_SIZES, cards)):
        head = (rng.zipf(1.05, B) - 1) % card
        rest = (head[:, None] * 0x9E3779B1 + np.arange(1, size) * 0x85EBCA6B + f) % card
        cols.append((np.int64(f) << 44) | np.concatenate([head[:, None], rest], axis=1))
    ids = torch.from_numpy(np.concatenate(cols, axis=1).reshape(-1)).to(dev)
    n, nb = ids.shape[0], B * len(DCNV2_SIZES)
    lengths = torch.tensor(DCNV2_SIZES, dtype=torch.int32).repeat(B, 1)
    bags = pooling.bags_on(lengths, n, dev, "sum")
    u = dedup.unique_pairs(*hashing.split_ids_t(ids), n)
    cap, U = u.hi.shape[0], int(u.valid.sum())
    inv64 = u.inverse.long()
    bag_sorted = bags.of.long().index_select(0, u.order)

    def touches_two(starts, counts):
        """Runs from `starts` of `counts` positions: which touch <= 2 segments
        (an empty run, a row left at the memset's zero, touches none)."""
        return (counts == 0) | ((starts + counts - 1) // S - starts // S <= 1)

    starts = torch.cumsum(lengths.reshape(-1).long(), 0) - lengths.reshape(-1).long()
    bag_exact = touches_two(starts, lengths.reshape(-1).long()).to(dev)
    runs = torch.bincount(inv64, minlength=cap)
    row_exact = touches_two(torch.cumsum(runs, 0) - runs, runs)
    cases = (
        ("forward: the unique rows pooled into the bags", inv64, bags.of, nb, bag_exact,
         lambda: torch.randn((cap, D), device=dev, generator=g) * 0.05, U),
        ("backward: the bags' gradient into the unique rows", bag_sorted, u.sorted_ids, cap,
         row_exact, lambda: torch.randn((nb, D), device=dev, generator=g) * 1e-3, nb),
    )
    out = []
    for label, order, srows, rows, exact, make, distinct in cases:
        srcs = [make() for _ in range(2)]
        got = segment_sum_gather(srcs[0], order, srows, rows)
        again = segment_sum_gather(srcs[0], order, srows, rows)
        want = segment_sum_gather(srcs[0].cpu(), order.cpu(), srows.cpu(), rows).to(dev)
        torch.cuda.synchronize()
        if not torch.equal(_bits(got), _bits(again)):
            raise AssertionError(f"segment_sum_gather {label}: two calls gave different bits")
        if not torch.equal(_bits(got[exact]), _bits(want[exact])):
            raise AssertionError(f"segment_sum_gather {label}: runs touching <= 2 segments "
                                 f"differ from the plain version")
        err = within_order_bound(got, want, order_bound(
            torch.zeros_like(got), srows, srcs[0].index_select(0, order)))
        log(f"check segment_sum_gather {label}: n={n}, {nb} bags, {U} unique ids, S={S}; "
            f"{int(exact.sum())} of {rows} rows bit-exact, the rest within the order bound "
            f"(max |kernel - plain| {err})")
        o32 = order.to(torch.int32)
        out.append(("row_merge_add", entry(
            f"DLRM-DCNv2 bag pool {label} (segment_sum_gather)",
            f"[{srcs[0].shape[0]}, {D}] f32 through n={n} positions -> [{rows}, {D}] f32 "
            f"({nb} bags, {U} unique ids)",
            12 * n + 4 * D * (distinct + rows),
            [lambda x=x: segment_sum_gather(x, order, srows, rows) for x in srcs],
            [lambda x=x: torch.zeros((rows, D), device=dev).index_add_(
                0, srows.long(), x.index_select(0, order)) for x in srcs],
            [lambda x=x: segment_sum(row_gather(x, o32), srows, rows,
                                     torch.arange(n, device=dev), srows) for x in srcs],
            lambda: err,
            "segment_",
        )))
        host_time(f"segment_sum_gather {label}",
                  lambda: segment_sum_gather(srcs[0], order, srows, rows))
        del srcs, got, again, want
        torch.cuda.empty_cache()

    rows_u = (torch.randn((cap, D), device=dev, generator=g) * 0.05).requires_grad_(True)
    grad = torch.randn((nb, D), device=dev, generator=g)
    torch.cuda.synchronize()
    reset_launches()
    dedup.GatherRows.apply(rows_u, u.inverse, u.order, u.sorted_ids, bags).backward(grad)
    torch.cuda.synchronize()
    counts = launches()
    if counts != {**{k: 0 for k in counts}, "row_merge_add": 4}:
        raise AssertionError(f"a bag pool's forward and backward launched {counts}, not 4 "
                             f"row_merge_add (two kernels each) and nothing else")
    log(f"check GatherRows bag pool forward + backward: launches {counts}")
    log_timings(out)
    return out


def check_train_parity(seed: int) -> None:
    """3 Trainer steps on the card and on the CPU from one state (tower from
    one CPU generator, empty 2^16-slot table, the same batches). Dense
    params are held within atol 1e-4: one Adam step moves a weight by up to
    lr = 1e-3 whatever the size of its gradient, so a gradient within
    rounding of zero (f32 sums in another order on the card) may move it
    by a different amount."""
    table_cfg = TableConfig(dim=32, capacity=1 << 16)
    run_cfg = RunConfig(batch_size=512, steps=3, seed=seed)
    stream = SyntheticStream(SyntheticConfig(batch_size=512, seed=seed + 5))
    batches = list(stream.batches(3))
    trainers = {d: Trainer(run_cfg, table_cfg, ModelConfig(), device=d) for d in ("cpu", "cuda")}
    losses = {d: [tr.train_step(b)["loss"] for b in batches] for d, tr in trainers.items()}
    cpu, gpu = trainers["cpu"].shard, trainers["cuda"].shard
    for name in ("key_hi", "key_lo", "freq", "last", "cnt", "ovf", "counters"):
        if not torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"train parity: {name} differs between card and CPU")
    errs = {}
    for name, got, want, tol in (
        ("values", gpu.values, cpu.values, dict(rtol=1e-5, atol=1e-6)),
        ("accum", gpu.opt_rowwise[0], cpu.opt_rowwise[0], dict(rtol=1e-5, atol=1e-6)),
        ("loss", torch.tensor(losses["cuda"]), torch.tensor(losses["cpu"]),
         dict(rtol=1e-5, atol=1e-6)),
        ("params", torch.cat([p.detach().reshape(-1) for p in trainers["cuda"].params]),
         torch.cat([p.detach().reshape(-1) for p in trainers["cpu"].params]),
         dict(rtol=0.0, atol=1e-4)),
    ):
        got = got.cpu()
        errs[name] = float((got - want).abs().max())
        torch.testing.assert_close(got, want, **tol, msg=lambda m, n=name: f"train parity {n}: {m}")
    log(f"check train parity: 3 steps of 512 x 26 ids, card vs CPU: planes and counters "
        f"equal ({trainers['cuda'].counters()}); max |card - CPU| {errs}; losses "
        f"{losses['cuda']}")


# --- serving -------------------------------------------------------------------

def make_request(rng, pools, batch, nsparse, unknown_frac=0.1):
    """[batch, nsparse] ids: live ids drawn from `pools` (id arrays, sampled
    in turn), a share of unknown (negative, never inserted) ids."""
    n = batch * nsparse
    ids = np.empty(n, np.int64)
    src = rng.integers(0, len(pools), size=n)
    for k, pool in enumerate(pools):
        sel = src == k
        ids[sel] = pool[rng.integers(0, len(pool), size=int(sel.sum()))]
    unknown = rng.random(n) < unknown_frac
    ids[unknown] = -rng.integers(1, 2**62, size=int(unknown.sum()))
    return ids.reshape(batch, nsparse)


KERNELS = (row_gather, row_scatter_set, row_scatter_add, row_merge_add, bucket_probe)
# the DMA probe's kernels (K6, K7): only the dma phase launches them, and
# their counters are set to 0 only there
DMA_KERNELS = (row_block_gather, row_block_scatter)


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def dma_launches() -> dict:
    return {k.__name__: k.launches for k in DMA_KERNELS}


SPANS = collections.Counter()


def counted_span(name: str):
    """`tracing.span` that also counts the spans entered, by name. Installed
    as `table_ops.span`, it counts each insert-planning round where it runs
    (`meepo.table.plan_round`), with no profiler running."""
    SPANS[name] += 1
    return tracing.span(name)


def plan_rounds() -> int:
    """Insert-planning rounds since the last `reset_launches()`."""
    return SPANS["meepo.table.plan_round"]


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    SPANS.clear()


def delta(before: dict, calls: int) -> str:
    now = launches()
    return ", ".join(f"{k} {(now[k] - before[k]) / calls:.2f}" for k in now)


def post_json(server, path: str, body: dict) -> dict:
    """The reply of a POST of `body` as JSON to `server`; raises unless 200."""
    code, rep = http_call(server.server_address[1], path, json.dumps(body).encode())
    if code != 200:
        raise AssertionError(f"POST {path}: {code} {rep}")
    return rep


def http_call(port: int, path: str, data: bytes = None):
    """(status, reply) of a GET (no data) or POST to 127.0.0.1:port; the
    reply parsed as JSON, /metrics' as text. A 4xx is returned, not raised."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, text = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        code, text = e.code, e.read().decode()
    return code, (text if path == "/metrics" else json.loads(text))


def score_body(dense, ids) -> bytes:
    return json.dumps({"dense": dense.tolist(), "ids": ids.tolist()}).encode()


def serving(svc, fn, retrieval=None):
    """Run fn(server) against an HTTP server of `svc`, then stop it."""
    server = make_http_server(svc, 0, retrieval=retrieval)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        return fn(server)
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)


def serve(args, dev, rng, card: str) -> dict:
    dim = 32
    table_cfg = TableConfig(dim=dim, capacity=args.capacity)
    model_cfg = ModelConfig()
    ckpt = ROOT / "build" / "chip_smoke" / "ckpt"
    shutil.rmtree(ckpt.parent, ignore_errors=True)
    t0 = time.perf_counter()
    keep = 1 << 20  # restored rows that requests draw from and are checked against
    written = write_checkpoint(ckpt, rng, args.ckpt_rows, args.part_rows, dim,
                               args.capacity, model_cfg, keep)
    log(f"serve: wrote checkpoint of {args.ckpt_rows} rows in "
        f"{time.perf_counter() - t0:.1f} s")
    # the checkpoint stays for the int8 phase; the caller removes it
    at = launches()
    t0 = time.perf_counter()
    svc = ScoringService(str(ckpt), table_cfg, model_cfg, device=dev)
    sync(dev)
    restore_s = time.perf_counter() - t0
    table = svc.table
    planes = [getattr(table.shard, f.name) for f in dataclasses.fields(table.shard)]
    planes = [t for p in planes for t in (p if isinstance(p, tuple) else (p,))]
    gib = sum(t.numel() * t.element_size() for t in planes) / 2**30
    log(f"serve: table state {gib:.2f} GiB on {dev}")
    if len(table) != args.ckpt_rows or svc.stats()["step"] != 1000:
        raise AssertionError(f"restored {len(table)} rows at step {svc.stats()['step']}, "
                             f"wrote {args.ckpt_rows} at step 1000")
    nbatch = -(-args.ckpt_rows // min(1 << 16, 1 << max(10, (args.ckpt_rows - 1).bit_length())))
    log(f"serve: restored {len(table)} rows in {restore_s:.2f} s "
        f"({args.ckpt_rows / restore_s:.0f} rows/s) in {nbatch} batches; launches per "
        f"batch: {delta(at, nbatch)}; counters {table.counters()}")

    # the sharded_http phase's requests, scored here on the checkpoint alone
    http_single = serve_http_reference(args, svc, written["ids"][:keep], model_cfg, card)

    # fill toward the target live rows with table.assign, data made on the device
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    B = 1 << 16
    assigned = landed = calls = 0
    kept_ids, kept_rows = [], []
    at = launches()
    t0 = time.perf_counter()
    while len(table) < args.fill_rows and assigned < args.fill_rows:
        n = min(B, args.fill_rows - args.ckpt_rows - assigned)
        if n <= 0:
            break
        ids = torch.randint(1, 2**62, (n,), device=dev, dtype=torch.int64, generator=g)
        rows = (torch.rand((n, dim), device=dev, generator=g) - 0.5) * 0.1
        ok = table.assign(ids, rows)
        assigned += n
        calls += 1
        landed += int(ok.sum())
        if len(kept_ids) < 8:  # rows to check reads against
            okt = torch.from_numpy(ok).to(dev)
            kept_ids.append(ids[okt])
            kept_rows.append(rows[okt])
    sync(dev)
    fill_s = time.perf_counter() - t0
    live = len(table)
    log(f"serve: assigned {assigned} rows in {fill_s:.1f} s ({assigned / fill_s:.0f} rows/s): "
        f"{landed} landed, {assigned - landed} dropped; live rows {live}, "
        f"load {table.load_factor:.4f}; launches per batch: {delta(at, -(-assigned // B))}")
    if landed < 0.99 * assigned:
        raise AssertionError(f"only {landed} of {assigned} assigned rows landed (< 99%)")
    sets = launches()["row_scatter_set"] - at["row_scatter_set"]
    if dev.type == "cuda" and sets != 3 * calls:
        raise AssertionError(f"assign launched row_scatter_set {sets} times in {calls} "
                             f"batches, not 3 a batch (fresh keys, side planes, rows)")
    kept_ids = torch.cat(kept_ids)
    kept_rows = torch.cat(kept_rows)

    # requests: live ids from the checkpoint and the fill, 10% unknown
    pools = [written["ids"][:keep], kept_ids.cpu().numpy()]
    nd, ns = model_cfg.num_dense_features, model_cfg.num_sparse_features
    reqs = [(rng.standard_normal((args.batch, nd), dtype=np.float32),
             make_request(rng, pools, args.batch, ns)) for _ in range(args.requests + 3)]
    at, paths = launches(), score_paths(svc)
    for dense, ids in reqs[:3]:  # warm-up: on the card, the size's capture and two replays
        svc.score(dense, ids)
    hold_score_launches("the serve warm-up", svc, at, paths, dev)
    lat, scores = [], []
    at, paths = launches(), score_paths(svc)
    for dense, ids in reqs[3:]:
        t0 = time.perf_counter()
        p = svc.score(dense, ids)
        lat.append((time.perf_counter() - t0) * 1e3)
        scores.append(p)
        if p.shape != (args.batch,) or not np.all(np.isfinite(p)) or not np.all((p > 0) & (p < 1)):
            raise AssertionError(f"scores must be finite probabilities in (0, 1): "
                                 f"shape {p.shape}, range [{p.min()}, {p.max()}]")
    lat = np.asarray(lat)
    ids_per_req = args.batch * ns
    log(f"serve: {len(lat)} requests of {args.batch} x {ns} ids: p50 {np.percentile(lat, 50):.3f} ms, "
        f"p99 {np.percentile(lat, 99):.3f} ms, mean {lat.mean():.3f} ms, "
        f"{ids_per_req * len(lat) / (lat.sum() / 1e3):.0f} ids/s on {card}; launches per "
        f"request on the host's counters: {delta(at, len(lat))}; requests by path "
        f"{score_paths(svc)}")
    replays = svc.graph_replays - paths[1]
    if dev.type == "cuda" and replays != len(lat):
        raise AssertionError(f"{replays} of the {len(lat)} timed requests were graph replays, "
                             f"not every one: each follows a warm-up request of its size")
    hold_score_launches("the timed requests", svc, at, paths, dev)
    if dev.type == "cuda":  # the kernels inside a replay, on the device's own record
        _, seen, made = profile_pass([lambda: svc.score(*reqs[3])], host=False, flush=False)
        if (seen, made) != (3, 0):
            raise AssertionError(f"a traced replay ran {seen} launches of the repo's kernels "
                                 f"and its wrappers counted {made}, not 3 (1 bucket_probe, 2 "
                                 f"row_gather: the values, the inverse) and 0")
        log(f"serve: a traced replay ran {seen} launches of the repo's kernels (1 bucket_probe, "
            f"2 row_gather), none counted on the host")

    # one request's rows against the rows that were written (restored from
    # the checkpoint or assigned), and zero rows for the unknown ids
    dense, ids = reqs[3]
    flat = torch.from_numpy(ids.reshape(-1)).to(dev)
    with torch.no_grad():
        got = table.lookup(flat, train=False)
    want = torch.zeros_like(got)
    counts = []
    sources = (
        (torch.from_numpy(written["ids"][:keep]).to(dev),
         torch.from_numpy(written["values"]).to(dev)),
        (kept_ids, kept_rows),
    )
    for src_ids, src_rows in sources:
        order = torch.argsort(src_ids)
        pos = torch.searchsorted(src_ids[order], flat).clamp(max=len(order) - 1)
        hit = src_ids[order][pos] == flat
        want[hit] = src_rows[order[pos[hit]]]
        counts.append(int(hit.sum()))
    unknown = int((flat < 0).sum())
    if sum(counts) + unknown != flat.shape[0]:
        raise AssertionError("the check request holds ids of no known source")
    if not torch.equal(got, want):
        raise AssertionError("looked-up rows differ from the rows written")
    # and against a plain values[slot] of each id's probed slot
    hi, lo = hashing.split_ids_t(flat)
    pr = table_ops.probe(table.spec, table.shard, hi, lo, hashing.is_valid(hi, lo))
    plain = table.shard.values[pr.slot.clamp(min=0).long()] * pr.found[:, None]
    if not torch.equal(got, plain):
        raise AssertionError("looked-up rows differ from values[slot]")
    log(f"serve: request rows equal the rows written and values[slot]: {counts[0]} "
        f"restored ids, {counts[1]} assigned ids, {unknown} unknown ids (zero rows)")

    # the same request's scores against the tower on the CPU, on the rows above
    cpu_model = copy.deepcopy(svc.model).cpu()
    emb = got.cpu().reshape(args.batch, ns, dim)
    with torch.no_grad():
        ref = torch.sigmoid(cpu_model(torch.from_numpy(dense), emb)).numpy()
    np.testing.assert_allclose(scores[0], ref, rtol=1e-5, atol=1e-6)
    log("serve: scores agree with the tower on the CPU (rtol 1e-5, atol 1e-6)")

    # one POST /score through the HTTP server
    body = {"dense": dense.tolist(), "ids": ids.tolist()}
    http_scores = serving(svc, lambda s: post_json(s, "/score", body))["scores"]
    np.testing.assert_allclose(http_scores, scores[0], atol=1e-6)
    log("serve: POST /score matches the direct score")
    return {"svc": svc, "requests": reqs[3:], "assigned": kept_ids, "ckpt": ckpt,
            "written": {"ids": written["ids"][:keep], "values": written["values"]},
            "http_single": http_single}


HTTP_DIR = ROOT / "build" / "chip_smoke_http"  # what the sharded_http phase reads
HTTP_WARM = 5  # warm-up requests of the HTTP timings


def serve_http_reference(args, svc, ids_pool, mc, card: str) -> dict:
    """The sharded_http phase's /score requests: HTTP_WARM warm-up and
    --requests timed ones of --batch x 26 ids of the checkpoint (10%
    unknown), and one of 37 rows. Their scores by `svc` (the checkpoint
    alone) go to HTTP_DIR with them; each POST /score to `svc`'s own
    server must equal them. Returns the single-device HTTP p50/p99."""
    rng = np.random.default_rng(args.seed + 131)
    nd, ns = mc.num_dense_features, mc.num_sparse_features
    reqs = [(rng.standard_normal((b, nd), dtype=np.float32), make_request(rng, [ids_pool], b, ns))
            for b in [args.batch] * (HTTP_WARM + args.requests) + [37]]
    scores = [svc.score(d, i) for d, i in reqs]
    bodies = [score_body(d, i) for d, i in reqs]

    def post_all(server):
        lat = []
        for body, want in zip(bodies, scores):
            t0 = time.perf_counter()
            code, rep = http_call(server.server_address[1], "/score", body)
            lat.append((time.perf_counter() - t0) * 1e3)
            if code != 200:
                raise AssertionError(f"single-device POST /score: {code} {rep}")
            np.testing.assert_allclose(rep["scores"], want, rtol=1e-5, atol=1e-6)
        return lat

    lat = np.asarray(serving(svc, post_all)[HTTP_WARM:HTTP_WARM + args.requests])
    HTTP_DIR.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for j, ((d, i), p) in enumerate(zip(reqs, scores)):
        arrays.update({f"dense{j}": d, f"ids{j}": i, f"scores{j}": p})
    np.savez(HTTP_DIR / "serve_ref.npz", **arrays)
    out = {"p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99))}
    log(f"serve: {len(lat)} POST /score of {args.batch} x {ns} ids to the single-device service "
        f"on the checkpoint: p50 {out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms on {card}; "
        f"{len(reqs)} requests' scores kept for the sharded_http phase")
    return out


def train(args, table, dev, card: str) -> dict:
    """Training steps on the serve phase's table, in place. Returns the
    trainer and spare batches for the timing and profile phases. On the
    card: TRAIN_BATCH examples a step, TRAIN_STEPS timed steps; in a
    rehearsal: --batch examples, 3 steps."""
    bsz, nsteps = (args.batch, 3) if args.rehearse_on_cpu else (TRAIN_BATCH, TRAIN_STEPS)
    run_cfg = RunConfig(batch_size=bsz, steps=nsteps + 5, seed=args.seed)
    model_cfg = ModelConfig()
    stream = SyntheticStream(SyntheticConfig(batch_size=bsz, seed=args.seed + 11))
    warm = 5
    batches = list(stream.batches(warm + nsteps + 5))  # 4 profiled, 1 timing
    tr = Trainer(run_cfg, table.cfg, model_cfg, device=dev,
                 generator=torch.Generator().manual_seed(args.seed + 13), shard=table.shard)
    ids_per_step = bsz * model_cfg.num_sparse_features
    before = tr.counters()
    live0 = len(table)
    losses, lat = [], []
    for i, b in enumerate(batches[:warm + nsteps]):
        if i == warm:
            timed_from = tr.counters()
        t0 = time.perf_counter()
        # reading the loss syncs; so does each insert-planning round
        loss = tr.train_step(b)["loss"]
        lat.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if not np.isfinite(loss):
            raise AssertionError(f"train step {i}: loss {loss}")
    sync(dev)
    after = tr.counters()
    diff = {k: after[k] - before[k] for k in ("hits", "misses", "inserts", "drops", "denied")}
    timed = {k: after[k] - timed_from[k] for k in ("hits", "misses", "inserts", "drops")}
    lat = np.asarray(lat[warm:])
    steps = len(lat)
    log(f"train: {warm} warm-up + {steps} timed steps of {bsz} x "
        f"{model_cfg.num_sparse_features} one-hot ids (Zipf a=1.2) on a table of "
        f"{live0} live rows, load {live0 / tr.spec.capacity:.4f} at the start")
    log(f"train: step p50 {np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, "
        f"mean {lat.mean():.3f} ms; {bsz * steps / (lat.sum() / 1e3):.0f} "
        f"examples/s, {ids_per_step * steps / (lat.sum() / 1e3):.0f} ids looked up + "
        f"updated per s on {card}")
    log(f"train: unique ids per timed step {(timed['hits'] + timed['misses']) / steps:.1f}; "
        f"over all {warm + steps} steps: hits {diff['hits']}, inserts {diff['inserts']}, "
        f"drops {diff['drops']}, denied {diff['denied']} (timed steps: hits {timed['hits']}, "
        f"inserts {timed['inserts']}, drops {timed['drops']}); live rows {len(table)}, load "
        f"{len(table) / tr.spec.capacity:.4f}; loss first {losses[0]:.6f}, last "
        f"{losses[-1]:.6f}; AUC over all steps {tr.auc.compute():.4f}")
    if diff["drops"] > 0.01 * max(1, diff["inserts"]):
        raise AssertionError(f"{diff['drops']} drops > 1% of {diff['inserts']} inserts")
    if diff["inserts"] == 0 or diff["hits"] == 0:
        raise AssertionError("the train phase must both insert and hit")
    return {"trainer": tr, "spare": batches[warm + nsteps:], "steps": warm + nsteps}


def profile_train(tr, batches) -> None:
    """Device busy share and the heaviest ops of training steps."""
    run_profiled("train", lambda: [tr.train_step(b) for b in batches], len(batches),
                 "step")


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


# --- timing --------------------------------------------------------------------

def time_ms(fns, rounds: int = 5, iters: int = 24) -> float:
    """Median over `rounds` of the mean time of one call, cycling through
    `fns` (the same call on different inputs, so that the 50 MB L2 cache
    does not hold the rows of the call before, as it would not on the
    serving path)."""
    for fn in fns:
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for i in range(iters):
            fns[i % len(fns)]()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def max_abs_err(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want|, in float64 and in chunks (the planes are up to
    16 GiB); raises unless the two are bit-for-bit equal."""
    got, want = got.reshape(-1), want.reshape(-1)
    err, step = 0.0, 1 << 26
    for i in range(0, got.numel(), step):
        x, y = got[i:i + step], want[i:i + step]
        if not torch.equal(_bits(x), _bits(y)):
            raise AssertionError(f"{name} disagrees with its plain version at the main shape")
        err = max(err, float((x.double() - y.double()).abs().max()))
    return err


def device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


# the __global__ functions of the repo's kernels: a wrapper's launch is one of them
OUR_KERNELS = ("row_gather_vecs", "row_set_kernel", "row_add_vecs", "add_unique",
               "segment_walk", "segment_combine", "row_block_copy", "bucket_probe_kernel")
PROFILE_SESSIONS = 3  # profiler sessions device_ms tries before "not measured"
L2_FLUSH_WORDS = 1 << 26  # 256 MB of int32, five times the 50 MB L2


def recorded_launches(evs) -> int:
    return sum(e.count for e in evs if any(k in e.key for k in OUR_KERNELS))


def event_ms(fns) -> float:
    """Device time of one call: the median, over one pass through `fns`, of
    CUDA events around the call, each call behind an L2 flush (a 256 MB
    write, `bitwise_not_`). No call finds the rows of the call before in
    the L2, and the device is still busy with the flush (about 160 us)
    while the host enqueues the call, so the events time its device work
    and the gap before its first kernel, not its host side."""
    buf = torch.zeros(L2_FLUSH_WORDS, dtype=torch.int32, device="cuda")
    marks = []
    for fn in fns:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        buf.bitwise_not_()
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in marks]))


def profile_pass(fns, host: bool = True, flush: bool = True, warmup: bool = True):
    """One torch.profiler session over a pass through `fns` (tracing the
    host too with `host`; with `flush`, a 256 MB write, `bitwise_not_`,
    before each call; with `warmup`, an untraced pass first, the profiler's
    warm-up step): (the device events of the traced pass but the flush's
    and the step's span, the launches of the repo's kernels it recorded,
    the launches the wrappers made in it)."""
    buf = torch.zeros(L2_FLUSH_WORDS if flush else 1, dtype=torch.int32, device="cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1) if warmup else None
    torch.cuda.synchronize()
    with profile(activities=acts, schedule=sched) as prof:
        for _ in range(2 if warmup else 1):
            made = sum(launches().values()) + sum(dma_launches().values())
            for fn in fns:
                if flush:
                    buf.bitwise_not_()
                fn()
            torch.cuda.synchronize()
            made = sum(launches().values()) + sum(dma_launches().values()) - made
            if warmup:
                prof.step()
    # the schedule's ProfilerStep spans the whole pass on the device too
    evs = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
           and "bitwise_not" not in e.key and not e.key.startswith("ProfilerStep")]
    return evs, recorded_launches(evs), made


def device_ms(fns, kernel: str):
    """Device time of one call under torch.profiler, over one pass through
    `fns` (`profile_pass`: the host traced too, a warm-up pass first, the
    L2 as the rotating inputs leave it): all the device work the call
    launches, and the part spent in the kernel named `kernel`. A session
    counts only if it recorded every launch the wrappers made in it:
    sessions lose launches, and a pass divided by its calls then reads
    below the bytes bound. (None, None) after `PROFILE_SESSIONS` that did
    not: not measured."""
    for _ in range(PROFILE_SESSIONS):
        evs, seen, made = profile_pass(fns, flush=False)
        if seen == made > 0:
            return (sum(device_us(e) for e in evs) / len(fns) / 1e3,
                    sum(device_us(e) for e in evs if kernel in e.key) / len(fns) / 1e3)
    return None, None


def profiler_methods(label: str, fns, kernel: str) -> None:
    """Log the device time a call of `fns` under each way of timing it:
    the events behind an L2 flush (`event_ms`), and the profiler's reading
    of the kernel named `kernel` with the device traced alone or with the
    host, the L2 warm or flushed, with or without a warm-up pass, beside
    the launches each session recorded of those the wrappers made and the
    time of a recorded launch: what moves a reading below the bytes
    bound."""
    parts = [f"events, L2 flushed: {event_ms(fns):.4f} ms"]
    for host, flush, warmup in ((False, False, False), (True, False, False),
                                (True, True, False), (True, True, True)):
        evs, seen, made = profile_pass(fns, host=host, flush=flush, warmup=warmup)
        us = sum(device_us(e) for e in evs if kernel in e.key)
        per = f"{us / seen / 1e3:.4f}" if seen else "-"
        parts.append(f"profiler, {'host+device' if host else 'device'}, L2 "
                     f"{'flushed' if flush else 'warm'}, {'a' if warmup else 'no'} warm-up "
                     f"pass: {us / len(fns) / 1e3:.4f} ms ({seen} of {made} launches "
                     f"recorded; {per} ms a recorded one)")
    log(f"profiler methods [{label}]: " + "; ".join(parts))


def entry(label, shape, nbytes, kernel, plain, library, check, kname) -> dict:
    """One timing record: kernel, plain and library times (lists of calls on
    rotating inputs; CUDA events around 24 calls, so a call whose host side
    outlasts its device work is timed by its host side), the device time of
    one wrapper call and of its kernel alone (`device_ms`; None where not
    measured, and each None where it read below the bytes bound), the
    bytes bound and the checked max_abs_err."""
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    dev = dict(zip(("device_ms", "kernel_ms"), device_ms(kernel, kname)))
    for k, ms in dev.items():
        if ms is not None and ms < bound_ms:  # not a time of the HBM traffic
            log(f"timing [{label}]: {k} {ms:.4f} below its bound {bound_ms:.4f} ms: not kept")
            dev[k] = None
    e = {"label": label, "shape": shape, "ms": time_ms(kernel), **dev,
         "plain_ms": time_ms(plain), "library_ms": time_ms(library),
         "bound_ms": bound_ms, "max_abs_err": check()}
    torch.cuda.empty_cache()
    return e


def sector_bound_ms(idx, rows: int, passes: int, other_bytes: int) -> float:
    """The least time when each scattered 4-byte access moves its whole
    32-byte sector: the distinct sectors that the indices in [0, rows)
    touch, `passes` times (1: read; 2: read and written back), plus
    `other_bytes` of contiguous traffic, over the memory rate."""
    i = idx.long()
    sectors = int(torch.unique(i[(i >= 0) & (i < rows)] // 8).numel())
    return (32 * passes * sectors + other_bytes) / HBM_BYTES_PER_S * 1e3


def gather_entry(label, planes, idxs) -> dict:
    """The timing record of row_gather (one plane) or row_gather_multi (a
    list of planes) over the index sets `idxs`; library: one index_select
    a plane. The bound reads each distinct row once (a batch's padding
    repeats one row) and writes every output row; 4-byte rows also get
    their sector bound."""
    if isinstance(planes, torch.Tensor):
        call = (lambda p: lambda i: [row_gather(p, i)])(planes)
        planes = [planes]
    else:
        call = (lambda ps: lambda i: row_gather_multi(ps, i))(planes)
    k, (R, W), esize = len(planes), planes[0].shape, planes[0].element_size()
    n = idxs[0].shape[0]
    idx64 = [i.long() for i in idxs]
    distinct = int(torch.unique(idxs[0].clamp(0, R - 1)).numel())
    e = entry(
        label, (f"{k} x " if k > 1 else "") + f"{(R, W)} {planes[0].dtype}, n={n} "
        f"({distinct} distinct)",
        4 * n + k * (distinct + n) * W * esize,  # indices, rows read, rows written
        [lambda i=i: call(i) for i in idxs],
        [lambda i=i: row_gather_multi_plain(planes, i) for i in idxs],
        [lambda i=i: [torch.index_select(p, 0, i) for p in planes] for i in idx64],
        lambda: max(max_abs_err("row_gather", a, b) for i in idxs
                    for a, b in zip(call(i), row_gather_multi_plain(planes, i))),
        "row_gather_",
    )
    if W * esize == 4:
        e["sector_bound_ms"] = sector_bound_ms(idxs[0].clamp(0, R - 1), R, k, 4 * n + 4 * k * n)
    return e


def host_time(name: str, fn, calls: int = 200) -> float:
    """Host time of one wrapper call, logged and returned in us: the mean
    of `calls` calls on the host clock, with no synchronisation between
    them (a launch is timed by its enqueue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    log(f"host {name}: {us:.2f} us a call")
    return us


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def log_timings(out) -> None:
    for name, e in out:
        sector = (f", {e['sector_bound_ms']:.4f} ms (32-byte sectors)"
                  if "sector_bound_ms" in e else "")
        library = ("no library call" if e["library_ms"] is None
                   else f"library {e['library_ms']:.4f} ms")
        host = f", host {e['host_us']:.2f} us" if "host_us" in e else ""
        log(f"timing {name} [{e['label']}] {e['shape']}: kernel {e['ms']:.4f} ms (device "
            f"{fmt_ms(e['device_ms'])} a call, {fmt_ms(e['kernel_ms'])} in the kernel), "
            f"plain {e['plain_ms']:.4f} ms, {library}, "
            f"bound {e['bound_ms']:.4f} ms (bytes){sector}{host}; max |kernel - plain| "
            f"{e['max_abs_err']}")


def walk_positions(slot, uh, ul, nb: int) -> torch.Tensor:
    """For each found key, the 1-based position in its probe walk of the
    bucket that resolved it: bucket 2 (p0 ^ g) + h is position 2 g + h + 1."""
    hit = slot >= 0
    b = slot[hit] // LANES
    if nb == 1:
        return torch.ones_like(b)
    p0 = hashing.bucket_of(uh[hit], ul[hit], nb) >> 1
    return 2 * ((b >> 1) ^ p0) + (b & 1) + 1


# the benchmark's two configurations: their file, a training batch's examples
# and the share of a batch's ids that the table has not seen
PROBE_TABLES = (("dlrm-kaggle", 4096, 0.0283), ("dlrm-mlperf-tb", 8192, 0.0))


def time_bucket_probe(seed: int) -> list:
    """bucket_probe on the key planes of the benchmark's two filled tables:
    every vocabulary id of the configuration (id = feature << 44 | value) put
    through insert_rows in batches of 2^20 into a table of the
    configuration's capacity and probe rounds (a 1-wide values plane, which
    the probe never reads). The probe inputs are a training batch's worth of
    ids (B x 26), drawn uniformly from the vocabulary with the configuration's
    share of unknown ids, padded with invalid ids to the power of two that
    the step's dedup pads to; 8 such sets. Fails unless the kernel equals
    the plain version bit for bit, slot and found, on every set. Logs the
    share of the found keys resolved in the first to fourth bucket of their
    walk, and times the kernel (events, profiler device time, the wrapper's
    host time) beside the plain version and the bytes bound (14 bytes a key,
    512 a bucket visited, 16 a hit)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 19)
    out = []
    for name, batch, unknown_share in PROBE_TABLES:
        conf = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
        cards = torch.tensor(conf["cardinalities"], dtype=torch.int64, device=dev)
        off = torch.cat([cards.new_zeros(1), torch.cumsum(cards, 0)])
        total, tcfg = int(off[-1]), conf["table"]
        spec = TableSpec.from_config(TableConfig(dim=1, capacity=tcfg["capacity"],
                                                 max_probe_rounds=tcfg["max_probe_rounds"]))
        shard = alloc_shard(spec, dev)

        def ids_at(pos):
            f = torch.searchsorted(off[1:], pos, right=True)
            return (f << 44) | (pos - off[f])

        t0 = time.perf_counter()
        landed = 0
        for a in range(0, total, 1 << 20):
            hi, lo = hashing.split_ids_t(ids_at(torch.arange(a, min(a + (1 << 20), total),
                                                             device=dev)))
            landed += int(table_ops.insert_rows(
                spec, shard, hi, lo, torch.zeros((hi.shape[0], 1), device=dev),
                hashing.is_valid(hi, lo), 0).sum())
        sync(dev)
        if landed != total:
            raise AssertionError(f"bucket_probe {name}: {landed} of {total} ids landed")
        log(f"bucket_probe {name}: {total} ids in {spec.capacity} slots ({spec.num_buckets} "
            f"buckets, load {total / spec.capacity:.4f}) filled in "
            f"{time.perf_counter() - t0:.1f} s")

        n_ids = batch * 26
        n = 1 << (n_ids - 1).bit_length()
        sets = []
        for _ in range(8):
            ids = ids_at(torch.randint(0, total, (n_ids,), device=dev, generator=g))
            unknown = torch.rand((n_ids,), device=dev, generator=g) < unknown_share
            ids = torch.where(unknown, ids | (1 << 40), ids)  # values past every cardinality
            ids = torch.cat([ids, ids.new_full((n - n_ids,), int(hashing.EMPTY_ID))])
            hi, lo = hashing.split_ids_t(ids)
            sets.append((hi, lo, hashing.is_valid(hi, lo)))
        out.append(("bucket_probe", probe_entry(
            f"{name} training batch", f"load {total / spec.capacity:.4f}, {n_ids} ids "
            f"({unknown_share} unknown)", shard, spec, sets)))
        del shard
        torch.cuda.empty_cache()
    log_timings(out)
    return out


def probe_entry(label: str, about: str, shard, spec, sets) -> dict:
    """The timing record of bucket_probe on the shard's key planes over the
    input sets `sets` ((hi, lo, valid) each): fails unless the kernel equals
    the plain version bit for bit, slot and found, on every set; logs the
    share of found keys resolved in each bucket of the walk. The bound reads
    each key's 9 bytes and writes its 5, a 512-byte key_lo row for every
    bucket a valid key visits (all of its walk where it is absent) and a
    16-byte key_hi vector for every hit. No PyTorch call computes a probe
    (library: none)."""
    R, nb = spec.max_probe_rounds, spec.num_buckets
    walk = 1 if nb == 1 else 2 * ((min(R, nb) + 1) // 2)
    n = sets[0][0].shape[0]
    visited = hits = valid_keys = 0
    positions = []
    for hi, lo, valid in sets:
        slot, found = bucket_probe(shard.key_hi, shard.key_lo, hi, lo, valid, R)
        pslot, pfound = bucket_probe_plain(shard.key_hi, shard.key_lo, hi, lo, valid, R)
        if not (torch.equal(slot, pslot) and torch.equal(found, pfound)):
            raise AssertionError(f"bucket_probe [{label}] disagrees with its plain version")
        pos = walk_positions(slot, hi, lo, nb)
        visited += int(pos.sum()) + int((valid & ~found).sum()) * walk
        hits += int(found.sum())
        valid_keys += int(valid.sum())
        positions.append(pos)
    pos = torch.cat(positions)
    share = [float((pos == k).sum()) / max(1, pos.numel()) for k in range(1, 5)]
    log(f"bucket_probe [{label}]: kernel = plain bit for bit on {len(sets)} sets of n={n}; "
        f"found keys resolved in bucket 1, 2, 3, 4 of their walk: "
        + ", ".join(f"{x:.6f}" for x in share)
        + f"; {hits / len(sets):.1f} found and {visited / max(1, valid_keys):.4f} buckets "
        f"visited a valid key")
    calls = [lambda s=s: bucket_probe(shard.key_hi, shard.key_lo, *s, R) for s in sets]
    nbytes = (14 * n * len(sets) + 512 * visited + 16 * hits) / len(sets)
    dev_ms, kern_ms = device_ms(calls, "bucket_probe_kernel")
    e = {"label": label,
         "shape": f"2 x {tuple(shard.key_hi.shape)} int32, {about}, n={n}, rounds {R}",
         "ms": time_ms(calls), "device_ms": dev_ms, "kernel_ms": kern_ms,
         "plain_ms": time_ms([lambda s=s: bucket_probe_plain(shard.key_hi, shard.key_lo, *s, R)
                              for s in sets]),
         "library_ms": None, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "max_abs_err": 0.0,
         "host_us": host_time(f"bucket_probe [{label}]", calls[0]), "resolved_share": share}
    return e


def time_kernels(svc, requests, seed: int) -> list:
    """Each kernel at the main path's shapes on the live table's planes,
    on the inputs of 8 requests (gathers) or 8 restore-sized batches (sets),
    then held against its plain version on the same inputs. The timed sets
    write the planes' own contents back, so the table is unchanged; the
    checked sets write new random contents into two copies of the plane,
    one by the kernel and one by the plain version."""
    table = svc.table
    shard, spec = table.shard, table.spec
    dev = shard.values.device
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    out = []

    # each request's unique ids, padded as lookup pads them, and what the
    # lookup probes and gathers for them: the keys, the found slots
    slots, probe_sets = [], []
    for _, ids in requests[:8]:
        flat = torch.from_numpy(ids.reshape(-1)).to(dev)
        npad = 1 << (flat.shape[0] - 1).bit_length()
        flat = torch.cat([flat, flat.new_full((npad - flat.shape[0],), int(hashing.EMPTY_ID))])
        uniq = dedup.unique_pairs(*hashing.split_ids_t(flat), npad)
        pr = table_ops.probe(spec, shard, uniq.hi, uniq.lo, uniq.valid)
        slots.append(torch.where(pr.found, pr.slot, 0).to(torch.int32))
        probe_sets.append((uniq.hi, uniq.lo, uniq.valid))

    def set_check(plane, idxs, new_upd):
        got, want = plane.clone(), plane.clone()
        for i in idxs:
            upd = new_upd()
            row_scatter_set(got, i, upd)
            row_scatter_set_plain(want, i, upd)
        return max_abs_err("row_scatter_set", got, want)

    profiler_methods("values per request", [lambda i=i: row_gather(shard.values, i)
                                            for i in slots], "row_gather_")
    out.append(("row_gather", gather_entry("values per request", shard.values, slots)))
    out.append(("bucket_probe", probe_entry(
        "per request", f"load {table.load_factor:.4f}, a request's unique ids", shard, spec,
        probe_sets)))
    host_time("row_gather one plane (values)", lambda: row_gather(shard.values, slots[0]))

    # restore-batch-sized sets of live slots, writing back what is there:
    # one element per slot into the flat key plane, whole rows into the
    # values plane, as insert_rows writes them
    n = 1 << 16
    live = torch.nonzero(shard.key_hi.view(-1) != hashing.EMPTY_HI)[:, 0]
    batches = []
    for _ in range(8):
        pick = live[torch.randperm(live.shape[0], device=dev, generator=g)[:n]]
        keys = shard.key_hi.view(-1)[pick]
        batches.append(dict(slot=pick.to(torch.int32), slot64=pick, keys=keys,
                            upd=keys[:, None].contiguous(), rows=shard.values[pick]))
    set_idx = [x["slot"] for x in batches]
    kf, vals = shard.key_hi.view(-1, 1), shard.values
    x0 = batches[0]
    host_time("row_scatter_set one plane", lambda: row_scatter_set(kf, x0["slot"], x0["upd"]))
    out.append(("row_scatter_set", entry(
        "bucket-plane element set per restore batch",
        f"{tuple(kf.shape)} int32 (the {tuple(shard.key_hi.shape)} key plane), n={n}",
        4 * n + 2 * n * 4,  # indices, elements read, elements written
        [lambda x=x: row_scatter_set(kf, x["slot"], x["upd"]) for x in batches],
        [lambda x=x: row_scatter_set_plain(kf, x["slot"], x["upd"]) for x in batches],
        [lambda x=x: kf.view(-1).index_put_((x["slot64"],), x["keys"]) for x in batches],
        lambda: set_check(kf, set_idx, lambda: torch.randint(
            -(2**31), 2**31 - 1, (n, 1), device=dev, dtype=torch.int32, generator=g)),
        "row_set_kernel",
    )))
    out.append(("row_scatter_set", entry(
        "whole-row values set per restore batch",
        f"{tuple(vals.shape)} f32, n={n}",
        4 * n + 2 * n * spec.dim * 4,  # indices, rows read, rows written
        [lambda x=x: row_scatter_set(vals, x["slot"], x["rows"]) for x in batches],
        [lambda x=x: row_scatter_set_plain(vals, x["slot"], x["rows"]) for x in batches],
        [lambda x=x: vals.index_put_((x["slot64"],), x["rows"]) for x in batches],
        lambda: set_check(vals, set_idx, lambda: torch.randn(
            (n, spec.dim), device=dev, generator=g)),
        "row_set_kernel",
    )))

    # the restore batch's grouped calls, as insert_rows makes them: the
    # fresh keys (key_hi, key_lo), then the side planes (freq, last, accum;
    # tensors on restore), then the rows (the whole-row set above); each
    # writes back what the planes hold
    def flat(p):
        return p.view(-1, 1)

    keys = (flat(shard.key_hi), flat(shard.key_lo))
    side = (flat(shard.freq), flat(shard.last), flat(shard.opt_rowwise[0]))
    groups = {}
    for label, planes in (("fresh keys (key_hi, key_lo)", keys),
                          ("side planes (freq, last, accum)", side)):
        sets = [(x["slot"], x["slot64"], [p[x["slot64"]] for p in planes]) for x in batches]
        groups[label] = (planes, sets)
        out.append(("row_scatter_set", multi_set_entry(
            f"restore batch: {label}", planes, sets, g)))
    three = [(x, [(planes, sets[k]) for planes, sets in groups.values()])
             for k, x in enumerate(batches)]

    def three_calls(x, calls):
        for planes, (idx, _, values) in calls:
            row_scatter_set_multi(planes, idx, values)
        row_scatter_set(vals, x["slot"], x["rows"])

    def three_plain(x, calls):
        for planes, (idx, _, values) in calls:
            row_scatter_set_multi_plain(planes, idx, values)
        row_scatter_set_plain(vals, x["slot"], x["rows"])

    def six_library(x, calls):
        for planes, (_, i64, values) in calls:
            for p, v in zip(planes, values):
                p.view(-1).index_put_((i64,), v.view(-1))
        vals.index_put_((x["slot64"],), x["rows"])

    out.append(("row_scatter_set", entry(
        "restore batch: the three grouped calls (keys, side planes, rows)",
        f"2 + 3 bucket planes (flat [{shard.key_hi.numel()}, 1]) and {tuple(vals.shape)} "
        f"f32, n={n}",
        4 * n * 3 + 5 * 2 * n * 4 + 2 * n * spec.dim * 4,
        [lambda x=x, c=c: three_calls(x, c) for x, c in three],
        [lambda x=x, c=c: three_plain(x, c) for x, c in three],
        [lambda x=x, c=c: six_library(x, c) for x, c in three],
        # the three calls' own checks, each measured above on these batches
        lambda: max(t["max_abs_err"] for _, t in out[-3:]),
        "row_set_kernel",
    )))
    log_timings(out)
    return out


def multi_set_entry(label, planes, sets, g) -> dict:
    """The timing record of one row_scatter_set_multi call on flat [N, 1]
    views of 4-byte planes, over `sets` of (idx int32 [n] with -1 for rows
    not written, the written rows' int64 slots, one value a plane: an [n, 1]
    tensor or a scalar). The library time is one `index_put_` a plane. The
    check writes new random tensor values into two copies of the planes,
    one by the kernel and one by the plain version."""
    n, T = sets[0][0].shape[0], sets[0][1].shape[0]
    dev = planes[0].device
    values0 = sets[0][2]
    tensors = sum(isinstance(v, torch.Tensor) for v in values0)
    ok = [(i >= 0).nonzero()[:, 0] for i, _, _ in sets]

    def lib_values(values, rows):
        return [v[rows].view(-1) if isinstance(v, torch.Tensor)
                else torch.tensor(v, dtype=p.dtype, device=dev) for p, v in zip(planes, values)]

    lib = [(i64, lib_values(values, rows)) for (_, i64, values), rows in zip(sets, ok)]

    def library(i64, values):
        for p, v in zip(planes, values):
            p.view(-1).index_put_((i64,), v)

    def check():
        got, want = [p.clone() for p in planes], [p.clone() for p in planes]
        for idx, _, values in sets[:2]:
            new = [(torch.randint(-(2**31), 2**31 - 1, (n, 1), device=dev, dtype=torch.int32,
                                  generator=g).view(p.dtype) if isinstance(v, torch.Tensor) else v)
                   for p, v in zip(planes, values)]
            row_scatter_set_multi(got, idx, new)
            row_scatter_set_multi_plain(want, idx, new)
        return max(max_abs_err("row_scatter_set_multi", a, b) for a, b in zip(got, want))

    return entry(
        label,
        f"K={len(planes)} flat [{planes[0].shape[0]}, 1] planes "
        f"({', '.join(str(p.dtype).replace('torch.', '') for p in planes)}; {tensors} tensor "
        f"values, {len(planes) - tensors} scalars), n={n} ({T} written)",
        4 * n + (2 * tensors + (len(planes) - tensors)) * 4 * T,
        [lambda x=x: row_scatter_set_multi(planes, x[0], x[2]) for x in sets],
        [lambda x=x: row_scatter_set_multi_plain(planes, x[0], x[2]) for x in sets],
        [lambda x=x: library(*x) for x in lib],
        check,
        "row_set_kernel",
    )


def time_train_kernels(tr, batch, seed: int) -> list:
    """row_merge_add, row_scatter_add and the row_gathers of insert planning
    and the accumulator at the training path's shapes, on the inputs of one
    real step: after a train step on `batch`, the probe of
    its unique ids gives that step's slots, and the dedup its inverse.
    Timed calls add zeros to the live planes (the table is unchanged) on 8
    input sets, the slots shifted by a different multiple of a bucket each
    time (a bijection: still unique), so the L2 cache does not hold the
    rows of the call before. Checks add random updates into copies of the
    planes."""
    shard, spec = tr.shard, tr.spec
    dev = shard.values.device
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    ids = torch.from_numpy(batch["ids"]).to(dev)
    hi, lo = hashing.split_ids_t(ids.reshape(-1))
    n = hi.shape[0]
    uniq = dedup.unique_pairs(hi, lo, n)
    tr.train_step(batch)
    pr = table_ops.probe(spec, shard, uniq.hi, uniq.lo, uniq.valid)
    ok = pr.found
    T, C, W = int(ok.sum()), spec.capacity, spec.dim
    # the contract of the unique-row add: the step's valid slots are unique
    distinct = int(torch.unique(pr.slot[ok]).shape[0])
    log(f"check the step's slots: {T} valid, {distinct} distinct")
    if distinct != T:
        raise AssertionError("the train step's valid slots are not unique")
    shifts = [((pr.slot.long() + k * 7919 * LANES) % C) for k in range(8)]
    vrows = [torch.where(ok, s, -1).to(torch.int32) for s in shifts]
    vrow64 = [s[ok] for s in shifts]
    out = []

    # the values update: unique rows of the [2^27, 32] plane, f32 deltas
    vals = shard.values
    zero = torch.zeros((n, W), device=dev)
    zero_ok = zero[:T]

    def merge_check(plane, idxs, make_upd):
        got, want = plane.clone(), plane.clone()
        for i in idxs:
            upd = make_upd()
            row_merge_add(got, i, upd)
            row_merge_add_plain(want, i, upd)
        return max_abs_err("row_merge_add", got, want)

    out.append(("row_merge_add", entry(
        "values update per step (unique rows)",
        f"{tuple(vals.shape)} {vals.dtype}, m={n} ({T} valid rows)",
        4 * n + 4 * W * T + 2 * T * W * vals.element_size(),
        [lambda v=v: row_merge_add(vals, v, zero) for v in vrows],
        [lambda v=v: row_merge_add_plain(vals, v, zero) for v in vrows],
        [lambda v=v: vals.index_add_(0, v, zero_ok) for v in vrow64],
        lambda: merge_check(vals, vrows[:2], lambda: torch.randn(
            (n, W), device=dev, generator=g) * 1e-3),
        "add_unique",
    )))
    host_time("row_merge_add unique rows", lambda: row_merge_add(vals, vrows[0], zero))

    # the gradient segment sum: n batch-order rows into [U, 32], duplicates
    U = uniq.hi.shape[0]
    inv, inv64 = uniq.inverse, uniq.inverse.long()
    grads = [torch.randn((n, W), device=dev, generator=g) * 1e-3 for _ in range(8)]
    runs = int(torch.unique(inv).shape[0])

    order, sids = uniq.order, uniq.sorted_ids

    def seg_check():
        got = dedup.segment_sum_grads(grads[0], inv, U, order, sids)
        again = dedup.segment_sum_grads(grads[0], inv, U, order, sids)
        want = row_merge_add_plain(torch.zeros((U, W), device=dev), inv, grads[0])
        if not torch.equal(got, again):
            raise AssertionError("segment_sum: two calls gave different bits")
        return within_order_bound(got, want, order_bound(torch.zeros_like(got), inv, grads[0]))

    # the inverse and the updates read, the runs' rows written
    seg_bytes = 4 * n + 4 * W * n + 4 * W * runs
    seg_fns = [lambda x=x: dedup.segment_sum_grads(x, inv, U, order, sids) for x in grads]
    walk_ms = device_ms(seg_fns, "segment_walk")[1]
    combine_ms = device_ms(seg_fns, "segment_combine")[1]
    log(f"timing segment sum kernels: walk {fmt_ms(walk_ms)}, combine {fmt_ms(combine_ms)}")
    out.append(("row_merge_add", entry(
        f"gradient segment sum per step (duplicate rows, the dedup's sort, "
        f"S={segment_size()})",
        f"[{n}, {W}] f32 -> [{U}, {W}] f32 ({runs} distinct rows, longest run "
        f"{int(torch.bincount(inv.long()).max())})",
        seg_bytes,
        seg_fns,
        [lambda x=x: row_merge_add_plain(torch.zeros((U, W), device=dev), inv, x)
         for x in grads],
        [lambda x=x: torch.zeros((U, W), device=dev).index_add_(0, inv64, x) for x in grads],
        seg_check,
        "segment_",
    )))
    host_time("segment_sum", lambda: segment_sum(grads[0], inv, U, order, sids))

    # insert planning's gather of a round: both key planes' [nb, 128] rows
    # at every unique id's bucket of the round (b0 ^ r, r = 0-7 rotating)
    b0 = hashing.bucket_of(uniq.hi, uniq.lo, spec.num_buckets)
    out.append(("row_gather", gather_entry(
        "key buckets (key_hi, key_lo) per insert planning round",
        [shard.key_hi, shard.key_lo], [b0 ^ r for r in range(8)])))

    # the rowwise accumulator read alone, the plain K2 baseline of the
    # fetch-add below (the step no longer launches it): one f32 element per
    # unique slot of the plane's flat view, slots < 0 clamped
    acc = shard.opt_rowwise[0].view(-1, 1)
    out.append(("row_gather", gather_entry(
        "accumulator element read (no longer on the step's path)", acc,
        [v.clamp(min=0) for v in vrows])))

    # the rowwise accumulator's fetch-add (the step's call), then the plain
    # add: one f32 element per unique slot
    zero1 = torch.zeros((n, 1), device=dev)
    olds = [torch.empty((n, 1), device=dev) for _ in range(2)]

    def add_check(fetch):
        got, want = acc.clone(), acc.clone()
        err = 0.0
        for v in vrows[:2]:
            upd = torch.rand((n, 1), device=dev, generator=g)
            row_scatter_add(got, v, upd, olds[0] if fetch else None)
            row_scatter_add_plain(want, v, upd, olds[1] if fetch else None)
            if fetch:
                err = max(err, max_abs_err("row_scatter_add old", olds[0], olds[1]))
        return max(err, max_abs_err("row_scatter_add", got, want))

    def fetch_library(v64):
        acc.view(-1).index_select(0, v64)
        acc.view(-1).index_add_(0, v64, zero1[:T, 0])

    out.append(("row_scatter_add", entry(
        "rowwise accumulator fetch-add per step (the add and the old values)",
        f"{tuple(acc.shape)} f32 (the {tuple(shard.opt_rowwise[0].shape)} plane), m={n} "
        f"({T} valid)",
        4 * n + 3 * 4 * T + 4 * n,  # indices; updates, elements read and written; old
        [lambda v=v: row_scatter_add(acc, v, zero1, olds[0]) for v in vrows],
        [lambda v=v: row_scatter_add_plain(acc, v, zero1, olds[1]) for v in vrows],
        [lambda v=v: fetch_library(v) for v in vrow64],
        lambda: add_check(True),
        "row_add_",
    )))
    out[-1][1]["sector_bound_ms"] = sector_bound_ms(vrows[0], C, 2, 4 * n + 4 * T + 4 * n)
    host_time("row_scatter_add fetch-add", lambda: row_scatter_add(acc, vrows[0], zero1, olds[0]))
    host_time("row_scatter_add", lambda: row_scatter_add(acc, vrows[0], zero1))

    out.append(("row_scatter_add", entry(
        "rowwise accumulator add alone (the plain add)",
        f"{tuple(acc.shape)} f32 (the {tuple(shard.opt_rowwise[0].shape)} plane), m={n} "
        f"({T} valid)",
        4 * n + 3 * 4 * T,  # indices; updates read, elements read, elements written
        [lambda v=v: row_scatter_add(acc, v, zero1) for v in vrows],
        [lambda v=v: row_scatter_add_plain(acc, v, zero1) for v in vrows],
        [lambda v=v: acc.view(-1).index_add_(0, v, zero1[:T, 0]) for v in vrow64],
        lambda: add_check(False),
        "row_add_",
    )))
    out[-1][1]["sector_bound_ms"] = sector_bound_ms(vrows[0], C, 2, 4 * n + 4 * T)

    # the step's multi-plane set (lookup_train: the fresh keys' key_hi,
    # key_lo, freq = 1 and last = step) on copies of the four bucket planes,
    # at the step's slots
    planes = [p.clone().view(-1, 1) for p in (shard.key_hi, shard.key_lo, shard.freq, shard.last)]
    uh, ul = uniq.hi[:, None].contiguous(), uniq.lo[:, None].contiguous()
    sets = [(v, v64, [uh, ul, 1, tr.step]) for v, v64 in zip(vrows, vrow64)]
    out.append(("row_scatter_set", multi_set_entry(
        "train step: key_hi, key_lo, freq, last", planes, sets, g)))
    del planes
    log_timings(out)
    return out


def profile_phase(svc, reqs, seed: int) -> None:
    """Device busy share and the heaviest ops of scoring and of assign."""
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    dim = svc.table_cfg.dim
    batches = [(torch.randint(1, 2**62, (1 << 16,), device="cuda", generator=g),
                torch.rand((1 << 16, dim), device="cuda", generator=g)) for _ in range(4)]
    run_profiled("score", lambda: [svc.score(d, i) for d, i in reqs[:8]], 8, "call")
    run_profiled("assign", lambda: [svc.table.assign(i, r) for i, r in batches], 4, "call")


def run_profiled(name: str, fn, count: int, unit: str) -> None:
    """torch.profiler over `fn` (`count` calls): wall and device busy time per
    call, and the ops with the most device time."""
    torch.cuda.synchronize()
    made = sum(launches().values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    made = sum(launches().values()) - made
    ka = prof.key_averages()
    on_device = [e for e in ka if e.device_type.name == "CUDA"]
    busy_us = sum(device_us(e) for e in on_device)
    kernels = sum(e.count for e in on_device)
    top = sorted(ka, key=device_us, reverse=True)[:10]
    log(f"profile {name}: {count} {unit}s, wall {wall_us / count / 1e3:.3f} ms/{unit}, device "
        f"busy {busy_us / count / 1e3:.3f} ms/{unit} ({100 * busy_us / wall_us:.1f}% of wall), "
        f"{kernels / count:.0f} device kernels and copies per {unit}; "
        f"{recorded_launches(on_device)} of the {made} launches of the repo's kernels recorded")
    for e in top:
        log(f"profile {name}:   {e.key[:70]:70s} {device_us(e) / count:9.1f} us/{unit} "
            f"x{e.count / count:g}")


# --- lifecycle -----------------------------------------------------------------

LIFE_STEPS, LIFE_EVERY = 40, 5  # steps on the live table, maintenance() every 5
LIFE_WINDOW, LIFE_EVICT = 1 << 15, 1 << 14  # buckets scanned and rows evicted a pass
LIFE_REMOVE, LIFE_PROMOTE = 65_536, 4096  # ids removed, spilled ids promoted back
LIFE_DEPTH_CAP, LIFE_DEPTH_ROWS = 1 << 23, 6_000_000  # the reduced-depth table
LIFE_PART_ROWS = 1 << 22  # rows a part file of the streamed save


def _ms(s: float) -> str:
    return f"{s * 1e3:.3f} ms"


def _window_copy(shard, off: int, K: int) -> dict:
    """Plain copies (torch indexing, no kernel) of the evict window's bucket
    rows [off, off + K) mod nb of every plane a pass reads or exports."""
    nb = shard.cnt.shape[0]
    wrows = (off + torch.arange(K, device=shard.cnt.device)) % nb
    cp = {n: getattr(shard, n)[wrows].clone() for n in ("key_hi", "key_lo", "freq", "last")}
    cp["accum"] = shard.opt_rowwise[0][wrows].clone()
    slots = (wrows[:, None] * LANES + torch.arange(LANES, device=wrows.device)).view(-1)
    cp["values"] = shard.values[slots].clone()
    return cp


def _expected_export(cp: dict, policy, step: int):
    """A pass's export by the plain rule on the window's copy: the live LFU
    or TTL cold lanes in window order, the first max_evict_per_pass."""
    kh, kl = cp["key_hi"].view(-1), cp["key_lo"].view(-1)
    cold = (cp["freq"] < policy.lfu_min_freq) | ((step - cp["last"]) > policy.ttl_steps)
    idx = (hashing.is_valid(kh, kl) & cold.view(-1)).nonzero()[:, 0][:policy.max_evict_per_pass]
    ids = hashing.join_ids(kh[idx].cpu().numpy(), kl[idx].cpu().numpy())
    return ids, {"values": cp["values"][idx].cpu().numpy(),
                 "freq": cp["freq"].view(-1)[idx].cpu().numpy(),
                 "accum": cp["accum"].view(-1)[idx].cpu().numpy()}


def _check_spilled(store, ids, want: dict, dim: int) -> None:
    """The spill tier holds each id's payload equal, bit for bit, to the
    copy: values, freq and the accumulator."""
    payload, found = store.lookup_batch(ids)
    if not found.all():
        raise AssertionError(f"{int((~found).sum())} evicted ids are not in the spill tier")
    same = (np.array_equal(payload[:, :dim].view(np.int32), want["values"].view(np.int32))
            and np.array_equal(payload[:, dim], want["freq"].astype(np.float32))
            and np.array_equal(payload[:, dim + 1].view(np.int32), want["accum"].view(np.int32)))
    if not same:
        raise AssertionError("a pass's spilled rows differ from the window's planes before it")


def _found(spec, shard, ids) -> torch.Tensor:
    hi, lo = hashing.split_ids_t(ids)
    return table_ops.probe(spec, shard, hi, lo, hashing.is_valid(hi, lo)).found


def _launch_delta(before: dict) -> dict:
    now = launches()
    return {k: now[k] - before[k] for k in now}


def score_paths(svc) -> tuple:
    """A ScoringService's answered requests by path: (graph captures, graph
    replays, eager requests)."""
    return svc.graph_captures, svc.graph_replays, svc.eager_requests


def score_launches(captures: int, eager: int) -> dict:
    """The launches the kernel wrappers count for a ScoringService's one-hot
    requests: 1 bucket_probe and 2 row_gather (the values; the inverse) an
    eager request, twice that a graph's capture (an eager run on the capture
    stream, then the captured one), none a replay (a replay calls no
    wrapper)."""
    chains = eager + 2 * captures
    return {"bucket_probe": chains, "row_gather": 2 * chains}


def hold_score_launches(what: str, svc, before: dict, paths: tuple, dev) -> None:
    """Fail unless the one-hot requests `svc` answered since `before` (its
    launches) and `paths` (`score_paths`) counted what `score_launches`
    gives for their paths, and launched nothing else."""
    if dev.type != "cuda":
        return
    now = score_paths(svc)
    got = _launch_delta(before)
    want = {k: 0 for k in got}
    want.update(score_launches(now[0] - paths[0], now[2] - paths[2]))
    if got != want:
        raise AssertionError(f"{what} launched {got}, not {want} (captures, replays, eager: "
                             f"{paths} before, {now} after)")


def lifecycle_live(args, table, assigned, dev, card: str) -> dict:
    """Part a, at full width on the live table, in place: a Trainer with
    LFU/TTL eviction into a host-DRAM spill tier (`HostKVStore`) takes
    LIFE_STEPS steps with maintenance() every LIFE_EVERY; then `remove`,
    then promotion back from the spill tier through a table's train
    lookups."""
    rehearse = args.rehearse_on_cpu
    nb = table.spec.num_buckets
    policy = PolicyConfig(evict_policy="lfu_ttl", ttl_steps=20, lfu_min_freq=2,
                          max_evict_per_pass=LIFE_EVICT,
                          evict_scan_buckets=max(1, nb // 32) if rehearse else LIFE_WINDOW)
    cfg = dataclasses.replace(table.cfg, policy=policy)
    store = HostKVStore(SpillCodec(TableSpec.from_config(cfg)).width)
    bsz = args.batch if rehearse else TRAIN_BATCH
    tr = Trainer(RunConfig(batch_size=bsz, steps=LIFE_STEPS, seed=args.seed), cfg, ModelConfig(),
                 device=dev, generator=torch.Generator().manual_seed(args.seed + 29),
                 shard=table.shard, spill=store)
    tr.step = table.step  # the step clock goes on from the checkpoint's
    stream = SyntheticStream(SyntheticConfig(batch_size=bsz, seed=args.seed + 31,
                                             drift_per_step=500))
    c0 = tr.counters()
    step_ms, pass_ms, evicted, last_ids = [], [], 0, None
    on_card = dev.type == "cuda"
    for i, b in enumerate(stream.batches(LIFE_STEPS)):
        at, r0 = launches(), plan_rounds()
        t0 = time.perf_counter()
        loss = tr.train_step(b)["loss"]
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(loss):
            raise AssertionError(f"lifecycle step {i}: loss {loss}")
        d, rounds = _launch_delta(at), plan_rounds() - r0
        # LFU/TTL keeps scores: touch adds freq (a K3 add) and sets last (a set)
        want = {"row_gather": 2 + rounds, "row_scatter_set": 2, "row_scatter_add": 2,
                "row_merge_add": 3, "bucket_probe": 1}
        if on_card and d != want:
            raise AssertionError(f"lifecycle step {i} launched {d}, not {want}")
        step_launches = d
        if (i + 1) % LIFE_EVERY:
            continue
        off = tr._evict_cursor
        ids, want_rows = _expected_export(_window_copy(tr.shard, off, policy.evict_scan_buckets),
                                          policy, tr.step)
        sync(dev)
        at = launches()
        t0 = time.perf_counter()
        n = tr.maintenance()["evicted"]
        sync(dev)
        pass_ms.append((time.perf_counter() - t0) * 1e3)
        pass_launches = _launch_delta(at)
        want = {"row_gather": 3, "row_scatter_set": 2, "row_scatter_add": 0, "row_merge_add": 0,
                "bucket_probe": 0}
        if on_card and pass_launches != want:
            raise AssertionError(f"a maintenance pass launched {pass_launches}, not {want}")
        if n != len(ids) or n == 0:
            raise AssertionError(f"pass at bucket {off} evicted {n} rows; the plain rule on the "
                                 f"window's copy selects {len(ids)}")
        _check_spilled(store, ids, want_rows, cfg.dim)
        if bool(_found(tr.spec, tr.shard, torch.from_numpy(ids).to(dev)).any()):
            raise AssertionError("evicted ids still probe as present")
        evicted += n
        last_ids = ids
    c1 = tr.counters()
    spilled = c1["spills"] - c0["spills"]
    if not evicted == c1["evictions"] - c0["evictions"] == spilled == len(store) > 0:
        raise AssertionError(f"evicted {evicted}, counted {c1['evictions'] - c0['evictions']}, "
                             f"spilled {spilled}, spill tier holds {len(store)}")
    sync(dev)
    t0 = time.perf_counter()
    inv = table_ops.check_invariants(tr.spec, tr.shard)
    inv_s = time.perf_counter() - t0
    if any(inv.values()):
        raise AssertionError(f"invariants after the last pass: {inv}")
    step_ms, pass_ms = np.asarray(step_ms), np.asarray(pass_ms)
    log(f"lifecycle: {LIFE_STEPS} steps of {bsz} x 26 ids (drift 500 a step) on the live table "
        f"at step {table.step}+, LFU (freq < 2) / TTL (20 steps), a pass every {LIFE_EVERY} steps "
        f"over {policy.evict_scan_buckets} of {nb} buckets, <= {LIFE_EVICT} rows, into "
        f"HostKVStore; step p50 {np.percentile(step_ms, 50):.3f} ms on {card}")
    log(f"lifecycle: {len(pass_ms)} passes evicted {evicted} rows ({evicted // len(pass_ms)} a "
        f"pass), spilled {spilled}, spill tier {len(store)} rows; pass p50 "
        f"{np.percentile(pass_ms, 50):.3f} ms ({', '.join(f'{x:.2f}' for x in pass_ms)} ms), "
        f"{evicted / (pass_ms.sum() / 1e3):.0f} rows evicted + spilled a s on {card}; each "
        f"pass's spilled rows equal the window's planes before it, bit for bit, and its ids "
        f"probe absent")
    log(f"lifecycle: launches of a step {step_launches}, of a maintenance pass {pass_launches}")
    log(f"lifecycle: check_invariants over {tr.spec.capacity} slots in {_ms(inv_s)} on "
        f"{card}: {inv}")

    # removal of assigned ids (some may have been evicted already)
    rm = torch.unique(assigned[:min(LIFE_REMOVE, assigned.shape[0] // 2)])
    present = int(_found(table.spec, table.shard, rm).sum())
    e0 = table.counters()["erases"]
    sync(dev)
    t0 = time.perf_counter()
    removed = table.remove(rm)
    sync(dev)
    rm_s = time.perf_counter() - t0
    erases = table.counters()["erases"] - e0
    if not removed == erases == present or bool(_found(table.spec, table.shard, rm).any()):
        raise AssertionError(f"remove of {rm.shape[0]} ids: {present} present before, "
                             f"{removed} removed, erases +{erases}, or some still found")
    inv = table_ops.check_invariants(table.spec, table.shard)
    if any(inv.values()):
        raise AssertionError(f"invariants after remove: {inv}")
    log(f"lifecycle: remove of {rm.shape[0]} assigned ids ({present} still present) in "
        f"{_ms(rm_s)} ({rm.shape[0] / rm_s:.0f} ids/s) on {card}; none found after, "
        f"invariants {inv}")

    # promotion: spilled ids looked up by a table on the live shard
    pids = last_ids[:LIFE_PROMOTE]
    payload, found = store.lookup_batch(pids)
    if not found.all():
        raise AssertionError("ids of the last pass are missing from the spill tier")
    pt = DynamicEmbeddingTable(cfg, device=dev, spill=store, shard=table.shard)
    pt.step = tr.step
    try:
        sync(dev)
        t0 = time.perf_counter()
        pt.lookup(pids, train=True)  # misses: fresh rows, and the promoter is fed
        sync(dev)
        t1 = time.perf_counter()
        pt._promoter.flush()
        t2 = time.perf_counter()
        pt.lookup(pids, train=True)  # drains: the spilled state overwrites them
        sync(dev)
        promo_s = time.perf_counter() - t0
        parts = f"first lookup {_ms(t1 - t0)}, flush {_ms(t2 - t1)}, draining lookup " \
                f"{_ms(promo_s - (t2 - t0))}"
        rows = pt.lookup(pids, train=False).cpu().numpy()
        if not np.array_equal(rows.view(np.int32), payload[:, :cfg.dim].view(np.int32)):
            raise AssertionError("promoted rows differ from their spilled payload")
        if pt.counters()["promotes"] != len(pids) or store.lookup_batch(pids)[1].any():
            raise AssertionError(f"promotes {pt.counters()['promotes']} of {len(pids)}, or "
                                 "promoted ids still in the spill tier")
    finally:
        pt._promoter.close()
    log(f"lifecycle: promotion of {len(pids)} spilled ids (train lookup, flush, train "
        f"lookup) in {_ms(promo_s)} ({parts}) on {card}: rows equal their spilled payload bit "
        f"for bit, "
        f"promotes {len(pids)}, gone from the spill tier")
    return {"trainer": tr, "policy": policy, "pass_ms": pass_ms, "evicted": evicted}


def _fill(table, rows: int, seed: int, dev) -> None:
    """Assign `rows` random rows (ids and values from `seed`) in batches of
    65,536."""
    g = torch.Generator(device=dev).manual_seed(seed)
    for o in range(0, rows, 1 << 16):
        n = min(1 << 16, rows - o)
        table.assign(torch.randint(1, 2**62, (n,), device=dev, dtype=torch.int64, generator=g),
                     (torch.rand((n, table.spec.dim), device=dev, generator=g) - 0.5) * 0.1)


def _same_rows(got: dict, want: dict, what: str) -> None:
    """Export arrays equal row for row by id, bit for bit."""
    og, ow = np.argsort(got["ids"]), np.argsort(want["ids"])
    for k in want:
        a, b = got[k][og], want[k][ow]
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        if not np.array_equal(a, b):
            raise AssertionError(f"{what}: {k} differs")


def lifecycle_depth(args, dev, card: str) -> None:
    """Part b, at the same width and reduced depth: checkpoints (async and
    streamed) of a Trainer on a 2^23-slot table restored bit for bit, then
    online growth to 2^24 slots through a train lookup."""
    rehearse = args.rehearse_on_cpu
    cap = 1 << 14 if rehearse else LIFE_DEPTH_CAP
    nrows = 11_700 if rehearse else LIFE_DEPTH_ROWS  # load 0.715 either way
    part_rows = 1 << 13 if rehearse else LIFE_PART_ROWS
    bsz = args.batch if rehearse else TRAIN_BATCH
    cfg = TableConfig(dim=32, capacity=cap)
    table = DynamicEmbeddingTable(cfg, device=dev)
    _fill(table, nrows, args.seed + 37, dev)
    landed = len(table)
    tr = Trainer(RunConfig(batch_size=bsz, steps=5, seed=args.seed), cfg, ModelConfig(),
                 device=dev, generator=torch.Generator().manual_seed(args.seed + 41),
                 shard=table.shard)
    batches = list(SyntheticStream(SyntheticConfig(batch_size=bsz, seed=args.seed + 43))
                   .batches(5))
    for b in batches[:3]:
        tr.train_step(b)
    root = ROOT / "build" / "chip_smoke" / "lifecycle"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    env = os.environ.get("MEEPO_CKPT_CHUNK_ROWS")
    os.environ["MEEPO_CKPT_CHUNK_ROWS"] = str(part_rows)
    try:
        sync(dev)
        t0 = time.perf_counter()
        tr.save_checkpoint(str(root / "async"), async_=True)
        snap_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want_a = (export_shard_arrays(tr.spec, tr.shard), tr._dense(), tr.step)
        export_s = time.perf_counter() - t0
        for b in batches[3:]:
            tr.train_step(b)
        t0 = time.perf_counter()
        tr.finish_saves()
        wait_s = time.perf_counter() - t0
        sync(dev)
        t0 = time.perf_counter()
        m = tr.save_checkpoint(str(root / "sync"))
        save_s = time.perf_counter() - t0
        want_s = (export_shard_arrays(tr.spec, tr.shard), tr._dense(), tr.step)
        gdir = root / "sync" / m["dir"]
        nbytes = sum(f.stat().st_size for f in gdir.iterdir())
        parts = sorted(f.name for f in gdir.iterdir() if ".part" in f.name)
        rows = m["counts"][0]
        log(f"lifecycle: a Trainer on a {cap}-slot table filled to {landed} rows by assign, "
            f"{len(batches)} steps of {bsz} x 26 ids; async save: {_ms(snap_s)} on the caller's "
            f"thread (the snapshot; the same export again, the check's copy, {_ms(export_s)}), "
            f"joined {_ms(wait_s)} after that copy and 2 more steps; streamed "
            f"save of {rows} rows in {len(parts)} parts of {part_rows} rows: {_ms(save_s)}, "
            f"{rows / save_s:.0f} rows/s, {nbytes / save_s / 1e6:.1f} MB/s ({nbytes} bytes) on "
            f"{card}")
        for name, (want, dense, step) in (("async", want_a), ("sync", want_s)):
            t = DynamicEmbeddingTable(cfg, device=dev)
            sync(dev)
            t0 = time.perf_counter()
            got_m = t.load(str(root / name))
            sync(dev)
            load_s = time.perf_counter() - t0
            if got_m["step"] != step:
                raise AssertionError(f"{name} checkpoint at step {got_m['step']}, saved at {step}")
            _same_rows(export_shard_arrays(t.spec, t.shard), want, f"{name} checkpoint")
            for leaf_name in ("params", "opt_state"):
                for x, y in zip(load_dense(str(root / name), leaf_name), dense[leaf_name],
                                strict=True):
                    if x.dtype != y.dtype or not np.array_equal(x, y):
                        raise AssertionError(f"{name} checkpoint: a {leaf_name} leaf differs")
            log(f"lifecycle: {name} checkpoint restored {len(t)} rows in {_ms(load_s)} "
                f"({len(t) / load_s:.0f} rows/s) on {card}: ids, values, freq, last, accum and "
                f"every dense leaf equal the trainer's at step {step}, bit for bit")
            del t
        t2 = Trainer(RunConfig(batch_size=bsz), cfg, ModelConfig(), device=dev)
        t2.load_checkpoint(str(root / "sync"))
        for x, y in zip(to_jax_params(t2.model), want_s[1]["params"], strict=True):
            if not np.array_equal(x, y):
                raise AssertionError("Trainer.load_checkpoint: a parameter differs")
        del t2, tr, table
    finally:
        shutil.rmtree(root.parent, ignore_errors=True)
        if env is None:
            os.environ.pop("MEEPO_CKPT_CHUNK_ROWS")
        else:
            os.environ["MEEPO_CKPT_CHUNK_ROWS"] = env

    gt = DynamicEmbeddingTable(dataclasses.replace(cfg, grow_at_load=0.75), device=dev)
    _fill(gt, nrows, args.seed + 37, dev)
    before = export_shard_arrays(gt.spec, gt.shard)
    g = torch.Generator(device=dev).manual_seed(args.seed + 47)
    new = torch.randint(1, 2**62, (cap // 16,), device=dev, dtype=torch.int64, generator=g)
    sync(dev)
    t0 = time.perf_counter()
    gt.lookup(new, train=True)
    sync(dev)
    grow_s = time.perf_counter() - t0
    if gt.spec.capacity != 2 * cap:
        raise AssertionError(f"the table holds {gt.spec.capacity} slots after growth, not {2 * cap}")
    after = export_shard_arrays(gt.spec, gt.shard)
    keep = np.isin(after["ids"], before["ids"])
    if int(keep.sum()) != before["ids"].shape[0]:
        raise AssertionError("growth lost rows")
    _same_rows({k: v[keep] for k, v in after.items()}, before, "growth")
    log(f"lifecycle: growth: a {cap}-slot table (grow_at_load 0.75) of {before['ids'].shape[0]} "
        f"rows looked up {new.shape[0]} new ids (train=True) and grew to {gt.spec.capacity} "
        f"slots in {_ms(grow_s)} ({before['ids'].shape[0] / grow_s:.0f} rows rehashed a s, the "
        f"lookup included) on {card}; every earlier row's planes kept bit for bit")


def time_lifecycle_kernels(tr, policy, seed: int) -> list:
    """The lifecycle's new call shapes on the live table, as the timing
    phase times the others: the evict window's gather (4 planes, K bucket
    rows), the export's gathers (4-byte planes and values at E slots) and
    the clears (5 bucket planes set to scalars, and values rows to 0), at
    free slots so that the live table keeps its contents."""
    shard, spec = tr.shard, tr.spec
    dev = shard.values.device
    g = torch.Generator(device=dev).manual_seed(seed + 53)
    nb, K, E = spec.num_buckets, policy.evict_scan_buckets, policy.max_evict_per_pass
    out = []
    wins = [((k * 9973 * K + torch.arange(K, device=dev)) % nb).to(torch.int32) for k in range(8)]
    out.append(("row_gather", gather_entry(
        f"evict window: key_hi, key_lo, freq, last (K = {K} bucket rows)",
        [shard.key_hi, shard.key_lo, shard.freq, shard.last], wins)))
    live = hashing.is_valid(shard.key_hi, shard.key_lo).view(-1)

    def sample(idx):  # E distinct entries of idx, a new tensor each (no view of a perm)
        return idx[torch.randperm(idx.shape[0], device=dev, generator=g)[:E]].sort().values

    live_idx = live.nonzero()[:, 0]
    slots = [sample(live_idx).to(torch.int32) for _ in range(8)]
    flat = [p.view(-1, 1) for p in (shard.key_hi, shard.key_lo, shard.freq, shard.opt_rowwise[0])]
    out.append(("row_gather", gather_entry(
        "evict export: key_hi, key_lo, freq, accum per pass", flat, slots)))
    out.append(("row_gather", gather_entry("evict export: values per pass", shard.values, slots)))
    free_idx = (~live).nonzero()[:, 0]
    del live, live_idx
    frees = [sample(free_idx) for _ in range(8)]
    five = [p.view(-1, 1) for p in (shard.key_hi, shard.key_lo, shard.freq, shard.last,
                                    shard.opt_rowwise[0])]
    scalars = [hashing.EMPTY_HI, hashing.EMPTY_LO, 0, 0, 0.0]
    sets = [(f.to(torch.int32), f, scalars) for f in frees]
    out.append(("row_scatter_set", multi_set_entry(
        "evict clear: key_hi, key_lo, freq, last, accum (scalars, free slots)", five, sets, g)))
    vals = shard.values
    zero = torch.zeros((), dtype=vals.dtype, device=dev)
    frees32 = [f.to(torch.int32) for f in frees]

    def clear_check():
        got, want = vals.clone(), vals.clone()
        for f, f32 in zip(frees[:2], frees32):
            got[f] = 1.0
            want[f] = 1.0
            row_scatter_set_multi([got], f32, [0])
            row_scatter_set_multi_plain([want], f32, [0])
        return max_abs_err("row_scatter_set_multi", got, want)

    out.append(("row_scatter_set", entry(
        "evict clear: values rows = 0 (a scalar, free slots)",
        f"{tuple(vals.shape)} {vals.dtype}, n={E}",
        4 * E + E * spec.dim * vals.element_size(),  # indices, rows written
        [lambda f=f: row_scatter_set_multi([vals], f, [0]) for f in frees32],
        [lambda f=f: row_scatter_set_multi_plain([vals], f, [0]) for f in frees32],
        [lambda f=f: vals.index_put_((f,), zero) for f in frees],
        clear_check,
        "row_set_kernel",
    )))
    log_timings(out)
    return out


# --- shared by the later phases ---------------------------------------------------

TRAIN_STEP_LAUNCHES = {"row_scatter_set": 1, "row_scatter_add": 1, "row_merge_add": 3,
                       "row_gather": 2, "bucket_probe": 1}  # and 1 gather a planning round


def run_steps(name: str, step, batches, dev, card: str, want=None) -> dict:
    """`step(batch)` -> loss over the batches: the first 5 (1 in a
    rehearsal) warm up, the rest are timed. Fails on a non-finite loss and,
    on the card, unless each step launches exactly `want` (row_gather: plus
    1 a planning round). Returns the timings and the launches a step."""
    warm = 1 if dev.type == "cpu" else 5
    at, rounds0 = launches(), plan_rounds()
    losses, lat = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        loss = step(b)  # reading the loss syncs
        lat.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if not np.isfinite(loss):
            raise AssertionError(f"{name} step {i}: loss {loss}")
    sync(dev)
    steps = len(batches)
    rounds = plan_rounds() - rounds0
    per = {k: v / steps for k, v in _launch_delta(at).items()}
    lat = np.asarray(lat[warm:])
    shape = batches[0]["ids"].shape
    out = {"p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
           "examples_per_s": shape[0] * len(lat) / (lat.sum() / 1e3),
           "ids_per_s": int(np.prod(shape)) * len(lat) / (lat.sum() / 1e3),
           "loss_first": losses[0], "loss_last": losses[-1], "rounds": rounds / steps}
    log(f"{name}: {warm} warm-up + {len(lat)} timed steps of {' x '.join(map(str, shape))} "
        f"ids: step p50 {out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms; "
        f"{out['examples_per_s']:.0f} examples/s, {out['ids_per_s']:.0f} ids/s on {card}; "
        f"loss first {losses[0]:.6f}, last {losses[-1]:.6f}; launches per step: "
        + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
        + f", planning rounds {rounds / steps:.2f}")
    if dev.type == "cuda" and want is not None:
        for k, w in want.items():
            w = w + rounds / steps if k == "row_gather" else w
            if abs(per[k] - w) > 1e-9:
                raise AssertionError(f"{name}: {k} launched {per[k]:.2f} times a step, "
                                     f"not {w:.2f}")
    return out


def check_drops(name: str, c0: dict, c1: dict, share: float = 0.0) -> None:
    """Fails on drops above `share` of the inserts between two counter
    readings (0 on a fresh table; the live table's phases allow 1%)."""
    drops, inserts = c1["drops"] - c0["drops"], c1["inserts"] - c0["inserts"]
    log(f"{name}: inserts {inserts}, hits {c1['hits'] - c0['hits']}, drops {drops}")
    if drops > share * inserts:
        raise AssertionError(f"{name}: {drops} drops of {inserts} inserts")


def planes_agree(name: str, card_shard, cpu_shard) -> dict:
    """Card and CPU shards: integer planes and counters equal, float planes
    within rtol 1e-5 / atol 1e-6 (`check_train_parity`'s tolerance).
    Returns the largest differences."""
    for plane in ("key_hi", "key_lo", "freq", "last", "cnt", "ovf", "counters"):
        if not torch.equal(getattr(card_shard, plane).cpu(), getattr(cpu_shard, plane)):
            raise AssertionError(f"{name}: {plane} differs between card and CPU")
    errs = {}
    floats = [("values", card_shard.values, cpu_shard.values)]
    floats += [(f"rowwise{j}", a, b) for j, (a, b) in
               enumerate(zip(card_shard.opt_rowwise, cpu_shard.opt_rowwise))]
    floats += [(f"fulldim{j}", a, b) for j, (a, b) in
               enumerate(zip(card_shard.opt_fulldim, cpu_shard.opt_fulldim))]
    for plane, a, b in floats:
        a = a.cpu()
        errs[plane] = float((a - b).abs().max())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                   msg=lambda m, p=plane: f"{name} {p}: {m}")
    return errs


# --- int8 serving ------------------------------------------------------------------

def int8(args, res, dev, card: str) -> dict:
    """The int8 phase on the serve phase's checkpoint (module docstring)."""
    svc, written = res["svc"], res["written"]
    rng = np.random.default_rng(args.seed + 47)
    t0 = time.perf_counter()
    svc8 = ScoringService(str(res["ckpt"]), svc.table_cfg, svc.model_cfg, quantize="int8",
                          device=dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    q = svc8.table
    f32_bytes = sum(t.numel() * t.element_size() for t in _planes(svc.table.shard))
    log(f"int8: a QuantizedTable of {len(q)} rows (dim {q.dim}) built from the checkpoint "
        f"with its ScoringService in {build_s:.2f} s: {q.nbytes()} bytes on {dev} against "
        f"the f32 table state's {f32_bytes} ({f32_bytes / q.nbytes():.1f}x) and "
        f"{len(q) * (8 + 4 * q.dim)} bytes of f32 rows and ids "
        f"({len(q) * (8 + 4 * q.dim) / q.nbytes():.2f}x)")
    if len(q) != args.ckpt_rows:
        raise AssertionError(f"the int8 table holds {len(q)} rows, not {args.ckpt_rows}")

    # every row read back within half a code step, range / 510, of the f32
    # row, plus one rounding each of the scaled code (an ulp of the range)
    # and of the sum (an ulp of the row's largest magnitude)
    ids, vals = written["ids"], written["values"]
    at = launches()
    got = q.lookup(torch.from_numpy(ids).to(dev)).cpu().numpy()
    rng_row = vals.max(1) - vals.min(1)
    bound = rng_row / 510 + np.spacing(rng_row) + np.spacing(np.abs(vals).max(1))
    err = np.abs(got - vals)
    if not np.all(err <= bound[:, None]):
        raise AssertionError(f"int8 rows off by more than range/510 + 2 ulp: worst "
                             f"{float((err - bound[:, None]).max())} over")
    unknown = -rng.integers(1, 2**62, size=4096)
    if q.lookup(torch.from_numpy(unknown).to(dev)).any():
        raise AssertionError("unknown ids read non-zero int8 rows")
    log(f"int8: {len(ids)} rows read back ({int((ids >= 2**31).sum())} of ids >= 2^31) within "
        f"range/510 + 2 ulp of the f32 rows (largest error {float(err.max()):.3e}, largest "
        f"range/510 {float(rng_row.max() / 510):.3e}); 4096 unknown ids read zeros; "
        f"launches {_launch_delta(at)}")

    # requests of checkpoint ids (10% unknown): int8 against the f32 service
    nd, ns = svc.model_cfg.num_dense_features, svc.model_cfg.num_sparse_features
    reqs = [(rng.standard_normal((args.batch, nd), dtype=np.float32),
             make_request(rng, [ids], args.batch, ns)) for _ in range(args.requests + 3)]
    for dense, r in reqs[:3]:
        svc8.score(dense, r)
    lat, gap, gathers, probes = [], 0.0, 0, 0
    for dense, r in reqs[3:]:
        at = launches()
        t0 = time.perf_counter()
        p8 = svc8.score(dense, r)
        lat.append((time.perf_counter() - t0) * 1e3)
        d = _launch_delta(at)
        gathers += d["row_gather"]
        probes += d["bucket_probe"]
        gap = max(gap, float(np.abs(p8 - svc.score(dense, r)).max()))
    lat = np.asarray(lat)
    serve_gap = max(float(np.abs(svc8.score(d, r) - svc.score(d, r)).max())
                    for d, r in res["requests"])
    log(f"int8: {len(lat)} requests of {args.batch} x {ns} ids: p50 "
        f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms on {card}; "
        f"row_gather {gathers / len(lat):.2f} a request; largest |int8 - f32| score "
        f"{gap:.3e} (the serve phase's requests, whose assigned ids the checkpoint lacks: "
        f"{serve_gap:.3e})")
    if dev.type == "cuda" and (gathers, probes) != (2 * len(lat), 0):
        raise AssertionError(f"int8 requests launched row_gather {gathers} and bucket_probe "
                             f"{probes} times, not 2 a request (codes, side plane) and none")
    dense, r = reqs[3]
    http = serving(svc8, lambda s: post_json(s, "/score", {"dense": dense.tolist(),
                                                            "ids": r.tolist()}))
    np.testing.assert_allclose(http["scores"], svc8.score(dense, r), atol=1e-6)
    log("int8: POST /score matches the direct score")
    return {"svc": svc8, "requests": reqs[3:], "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)), "score_gap": gap}


def _planes(shard) -> list:
    planes = [getattr(shard, f.name) for f in dataclasses.fields(shard)]
    return [t for p in planes for t in (p if isinstance(p, tuple) else (p,))]


def time_int8_kernels(q, requests) -> list:
    """The int8 lookup's two gathers at a request's shape: the codes'
    [N, dim / 4] int32 view and the [N, 4] side plane, at 8 requests'
    positions."""
    pos = [torch.searchsorted(q.ids, torch.from_numpy(r.reshape(-1)).to(q.ids.device))
           .clamp_(max=len(q) - 1).to(torch.int32) for _, r in requests[:8]]
    return [("row_gather", gather_entry("int8 codes per request", q.values.view(torch.int32),
                                        pos)),
            ("row_gather", gather_entry("int8 side plane per request", q.side, pos))]


# --- retrieval -----------------------------------------------------------------------

RETR_CAP, RETR_ITEMS = 1 << 23, 1 << 20  # table slots; corpus (bench_retrieval.py's)
RETR_QUERIES, RETR_K, RETR_REQUESTS = 256, 100, 30  # bench_retrieval.py's defaults
HTTP_ITEMS = 1 << 16  # the sharded_http phase's corpus: the retrieval corpus cut


def check_topk(ret, svc, vecs, dense, qids, k: int, dev) -> float:
    """The index's top-k of some queries against a brute-force f32 q @ V.T
    over the item vectors `vecs` (embedded here): scores within 1e-4, keys
    equal wherever the scores around a rank are more than 1e-4 apart.
    Returns the largest score difference."""
    keys, scores = ret.retrieve(dense, qids, k=k)
    with torch.no_grad():
        rows = svc.table.lookup(qids.reshape(-1), train=False)
        qv = svc.model.embed_query(torch.from_numpy(dense).to(dev),
                                   rows.reshape(len(qids), qids.shape[1], -1))
        ref_s, ref_i = torch.topk(qv @ vecs.T, k, dim=1)
    ref_s, ref_i = ref_s.cpu().numpy(), ref_i.cpu().numpy()
    diff = float(np.abs(scores - ref_s).max())
    if diff > 1e-4:
        raise AssertionError(f"retrieval top-k scores {diff} from the brute-force ones")
    gaps = np.diff(ref_s, axis=1) * -1  # ref_s[r] - ref_s[r + 1]
    apart = np.ones_like(ref_s, dtype=bool)
    apart[:, :-1] &= gaps > 1e-4
    apart[:, 1:] &= gaps > 1e-4
    if not np.array_equal(keys[apart], ret.index.keys[ref_i[apart]]):
        raise AssertionError("retrieval top-k keys differ from the brute-force ones")
    return diff


def retrieval(args, dev, card: str) -> dict:
    """The retrieval phase (module docstring)."""
    rehearse = dev.type == "cpu"
    cap = args.capacity if rehearse else RETR_CAP
    bsz = args.batch if rehearse else TRAIN_BATCH
    nsteps = 3 if rehearse else 5 + TRAIN_STEPS
    n_items, nq, nreq = (1 << 12, 16, 3) if rehearse else (RETR_ITEMS, RETR_QUERIES,
                                                          RETR_REQUESTS)
    mc = zoo_model_cfg("two_tower")
    table_cfg = TableConfig(dim=32, capacity=cap)
    root = ROOT / "build" / "chip_smoke" / "retrieval"
    shutil.rmtree(root, ignore_errors=True)
    batches = list(SyntheticStream(SyntheticConfig(batch_size=bsz, seed=args.seed + 53))
                   .batches(nsteps + 4))
    train_b, held = batches[:nsteps], batches[nsteps:]
    tr = Trainer(RunConfig(batch_size=bsz, steps=nsteps, seed=args.seed), table_cfg, mc,
                 device=dev, generator=torch.Generator().manual_seed(args.seed + 55))
    c0 = tr.counters()
    out = {"train": run_steps("retrieval two_tower", lambda b: tr.train_step(b)["loss"],
                              train_b, dev, card, TRAIN_STEP_LAUNCHES)}
    check_drops("retrieval two_tower", c0, tr.counters())
    tr.save_checkpoint(str(root / "ckpt"))

    # the corpus: the held-out batches' items, then items of ids drawn from the
    # trained ids of each item column
    rng = np.random.default_rng(args.seed + 57)
    held_items = np.concatenate([b["ids"][:, mc.num_query_features:] for b in held])
    trained = np.concatenate([b["ids"] for b in train_b])
    rest = np.stack([rng.choice(np.unique(trained[:, j]), n_items - len(held_items))
                     for j in range(mc.num_query_features, mc.num_sparse_features)], axis=1)
    item_ids = np.concatenate([held_items, rest])
    query_pool = np.unique(trained[:, :mc.num_query_features])
    requests = [(rng.standard_normal((nq, mc.num_dense_features), dtype=np.float32),
                 rng.choice(query_pool, (nq, mc.num_query_features))) for _ in range(nreq + 2)]
    # (row_gather, bucket_probe) a lookup: f32 probes, int8 searches on the host
    gathers_a_lookup = {"none": (2, 1), "int8": (2, 0)}
    try:
        for quantize in ("none", "int8"):
            svc = ScoringService(str(root / "ckpt"), table_cfg, mc, quantize=quantize,
                                 device=dev)
            ret = RetrievalService(svc)
            at = launches()
            t0 = time.perf_counter()
            ret.build_index(item_ids)
            sync(dev)
            build_s = time.perf_counter() - t0
            lookups = -(-n_items // ret.embed_batch)
            d = _launch_delta(at)
            built = (d["row_gather"], d["bucket_probe"])
            with torch.no_grad():  # the item vectors, embedded here for the brute force
                vecs = torch.cat([svc.model.embed_item(svc.table.lookup(
                    item_ids[s:s + 8192].reshape(-1), train=False).reshape(
                        -1, mc.num_sparse_features - mc.num_query_features, table_cfg.dim))
                    for s in range(0, n_items, 8192)])
            diff = max(check_topk(ret, svc, vecs, d[:8], q[:8], RETR_K, dev)
                       for d, q in requests[:1])
            for d, q in requests[:2]:  # warm-up
                ret.retrieve(d, q, k=RETR_K)
            lat = []
            at = launches()
            for d, q in requests[2:]:
                t0 = time.perf_counter()
                keys, scores = ret.retrieve(d, q, k=RETR_K)
                lat.append((time.perf_counter() - t0) * 1e3)
            d = _launch_delta(at)
            per_req = (d["row_gather"] / len(lat), d["bucket_probe"] / len(lat))
            if dev.type == "cuda":
                run_profiled(f"retrieval {quantize}", lambda: [ret.retrieve(
                    d, q, k=RETR_K) for d, q in requests[2:6]], 4, "request")
            recall = ret.evaluate(held, ks=(1, 10, 100))
            lat = np.asarray(lat)
            log(f"retrieval {quantize}: index of {n_items} items x "
                f"{mc.num_sparse_features - mc.num_query_features} ids built in {build_s:.2f} s "
                f"({n_items / build_s:.0f} items/s, row_gather {built[0] / lookups:.2f} and "
                f"bucket_probe {built[1] / lookups:.2f} a lookup of "
                f"{ret.embed_batch} items); {len(lat)} requests of {nq} queries at k = "
                f"{RETR_K}: p50 {np.percentile(lat, 50):.3f} ms, p99 "
                f"{np.percentile(lat, 99):.3f} ms on {card} (row_gather {per_req[0]:.2f} and "
                f"bucket_probe {per_req[1]:.2f} a request); top-k of 8 queries = brute-force f32 q @ V.T (largest score "
                f"difference {diff:.3e}); evaluate on {recall['positives']} held-out "
                f"positives: " + ", ".join(f"{k} {v:.4f}" for k, v in recall.items()
                                            if k.startswith("recall")))
            want = gathers_a_lookup[quantize]
            if dev.type == "cuda" and (built != tuple(lookups * w for w in want)
                                       or per_req != want):
                raise AssertionError(f"retrieval {quantize}: (row_gather, bucket_probe) "
                                     f"{built} over {lookups} index lookups and {per_req} a "
                                     f"request, not {want} a lookup")
            out[quantize] = {"build_items_per_s": n_items / build_s,
                             "p50_ms": float(np.percentile(lat, 50)),
                             "p99_ms": float(np.percentile(lat, 99)), **recall}
            if quantize == "none":
                d, q = requests[2]
                body = {"dense": d.tolist(), "ids": q.tolist(), "k": RETR_K}
                got = serving(svc, lambda s: post_json(s, "/retrieve", body), retrieval=ret)
                keys, scores = ret.retrieve(d, q, k=RETR_K)
                if got["keys"] != keys.tolist() or not np.allclose(got["scores"], scores,
                                                                   atol=1e-6):
                    raise AssertionError("POST /retrieve differs from retrieve")
                log("retrieval: POST /retrieve matches retrieve")
                # the sharded_http phase's reference: the corpus cut to HTTP_ITEMS
                cut = RetrievalService(svc)
                cut.build_index(item_ids[:HTTP_ITEMS])
                keys, scores = cut.retrieve(d, q, k=RETR_K)
                HTTP_DIR.mkdir(parents=True, exist_ok=True)
                np.savez(HTTP_DIR / "retrieval_ref.npz", items=item_ids[:HTTP_ITEMS], dense=d,
                         ids=q, keys=keys, scores=scores)
                del cut
            del svc, ret, vecs
        shutil.move(str(root / "ckpt"), str(HTTP_DIR / "retrieval_ckpt"))
    finally:
        shutil.rmtree(root.parent, ignore_errors=True)
    return out


# --- the embed API -------------------------------------------------------------------

class UserModel(torch.nn.Module):
    """A model the trainers do not know: a logistic regression over the
    flattened [B, 26, 32] embeddings, updated by plain SGD."""

    def __init__(self, width: int, generator):
        super().__init__()
        self.w = torch.nn.Parameter(torch.randn(width, generator=generator) * 0.05)
        self.b = torch.nn.Parameter(torch.zeros(()))

    def forward(self, emb):
        return emb.reshape(emb.shape[0], -1) @ self.w + self.b


def embed_step(spec, shard, model, batch, step: int, dev) -> float:
    """embed.lookup -> the user model -> grads of emb and of the model ->
    embed.update and SGD."""
    ids = torch.from_numpy(batch["ids"]).to(dev)
    label = torch.from_numpy(batch["label"]).to(dev)
    hi, lo = hashing.split_ids_t(ids)
    ctx, emb = embed.lookup(spec, shard, hi, lo, step)
    logits = model(emb)
    loss = torch.nn.functional.binary_cross_entropy_with_logits(logits, label)
    g_emb, *g = torch.autograd.grad(loss, [emb, *model.parameters()])
    embed.update(spec, shard, ctx, g_emb)
    with torch.no_grad():
        for p, gp in zip(model.parameters(), g):
            p.sub_(0.05 * gp)
    return float(loss.detach())


def embed_phase(args, table, dev, card: str) -> dict:
    """The embed phase (module docstring)."""
    bsz = args.batch if dev.type == "cpu" else TRAIN_BATCH
    nsteps = 3 if dev.type == "cpu" else 5 + TRAIN_STEPS
    # (a) 3 steps on the card and on the CPU from one state
    cfg = TableConfig(dim=32, capacity=1 << 16)
    spec = TableSpec.from_config(cfg)
    small = list(SyntheticStream(SyntheticConfig(batch_size=512, seed=args.seed + 61))
                 .batches(3))
    runs = {}
    for d in (torch.device("cpu"), dev):
        shard = alloc_shard(spec, d)
        model = UserModel(26 * 32, torch.Generator().manual_seed(args.seed + 63)).to(d)
        losses = [embed_step(spec, shard, model, b, i, d) for i, b in enumerate(small)]
        runs[d.type] = (shard, model, losses)
    (cshard, cmodel, closs), (gshard, gmodel, gloss) = runs["cpu"], runs[dev.type]
    errs = planes_agree("embed parity", gshard, cshard)
    np.testing.assert_allclose(gloss, closs, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gmodel.w.detach().cpu(), cmodel.w.detach(), rtol=0, atol=1e-5)
    log(f"check embed parity: 3 steps of 512 x 26 ids through embed.lookup/update, {dev} vs "
        f"CPU: planes and counters equal; max |{dev} - CPU| {errs}; losses {gloss}")
    # (b) steps of 4096 x 26 ids on the live table
    model = UserModel(26 * 32, torch.Generator().manual_seed(args.seed + 65)).to(dev)
    batches = list(SyntheticStream(SyntheticConfig(batch_size=bsz, seed=args.seed + 67))
                   .batches(nsteps))
    c0 = table.counters()
    step0 = 10_000  # later than every step stamp of the earlier phases
    counter = iter(range(step0, step0 + nsteps))
    out = run_steps("embed live", lambda b: embed_step(table.spec, table.shard, model, b,
                                                       next(counter), dev),
                    batches, dev, card, TRAIN_STEP_LAUNCHES)
    check_drops("embed live", c0, table.counters(), share=0.01)
    return out


# --- the row-sharded layer (a world of one) -------------------------------------------

SHARDED_CAP = 1 << 26  # part b's fresh table: 148 bytes a slot, 9.3 GiB
SHARDED_STEPS = 30  # part b's timed steps a exchange, after 5 warm-up
SHARDED_SERVE_CAP = 1 << 24  # part c's services: the serve checkpoint's rows at load 0.5
SHARDED_LIFE_CAP = 1 << 20  # part d's table
# a step's launches at S = 1 (module docstring): the train phase's, plus the
# owner side's rows by its dedup inverse (a gather), the segment sum of the
# received gradients (2 K1) and, dense only, the gather of the returning rows
SHARDED_LAUNCHES = {
    "fast": TRAIN_STEP_LAUNCHES,
    "dense": {"row_scatter_set": 1, "row_scatter_add": 1, "row_merge_add": 5, "row_gather": 4,
              "bucket_probe": 1},
    "ragged": {"row_scatter_set": 1, "row_scatter_add": 1, "row_merge_add": 5, "row_gather": 3,
               "bucket_probe": 1},
}
SHARDED_REQUEST_GATHERS = 3  # the values, the returning rows, the inverse
SHARDED_REQUEST_PROBES = 1


def check_sharded_parity(seed: int, meshes: dict, dev) -> dict:
    """Part a: 3 ShardedTrainer steps of 512 x 26 ids on a 2^16-slot table
    on the card and on the CPU from one state, for the dense and the ragged
    exchange (FORCE_EXCHANGE on). The tower is held still (dense lr 0), as
    `check_zoo_parity` holds the two-tower's: Adam turns dense gradients
    within rounding of zero into steps of ~lr whose sign is rounding, which
    then move the embedding gradients of later steps; with a learning
    tower, the fast path (no exchange) drifted 7.3e-6 card vs CPU in 3
    steps of these batches (PERF.md, PR 8)."""
    cfg = TableConfig(dim=32, capacity=1 << 16)
    batches = list(SyntheticStream(SyntheticConfig(batch_size=512, seed=seed + 91)).batches(3))
    errs = {}
    for ragged in (False, True):
        run_cfg = RunConfig(batch_size=512, steps=3, seed=seed, pipeline_depth=0,
                            a2a_ragged=ragged, dense_learning_rate=0.0)
        trs = {k: ShardedTrainer(run_cfg, cfg, ModelConfig(), mesh=m,
                                 generator=torch.Generator().manual_seed(seed + 92))
               for k, m in meshes.items()}
        losses = {k: [tr.train_step(b)["loss"] for b in batches] for k, tr in trs.items()}
        card, cpu = trs["card"], trs["cpu"]
        name = "ragged" if ragged else "dense"
        errs[name] = planes_agree(f"sharded parity {name}", card.shard, cpu.shard)
        if card.counters() != cpu.counters():
            raise AssertionError(f"sharded parity {name}: counters {card.counters()} != "
                                 f"{cpu.counters()}")
        np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=1e-5, atol=1e-6)
        for a, b in zip(card.params, cpu.params):
            torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0.0, atol=1e-4)
        log(f"check sharded parity ({name} exchange, FORCE_EXCHANGE): 3 steps of 512 x 26 ids, "
            f"{dev} vs CPU: planes and counters equal (route drops "
            f"{card.counters()['route_drops']}); max |{dev} - CPU| {errs[name]}; losses "
            f"{losses['card']}")
    return errs


def sharded_steps(args, mesh, dev, card: str) -> dict:
    """Part b: 5 + SHARDED_STEPS steps of each exchange on a fresh table
    each, then 4 profiled steps. Returns the timings by exchange."""
    rehearse = dev.type == "cpu"
    bsz = args.batch if rehearse else TRAIN_BATCH
    nsteps = 3 if rehearse else 5 + SHARDED_STEPS
    cfg = TableConfig(dim=32, capacity=args.capacity if rehearse else SHARDED_CAP)
    batches = list(SyntheticStream(SyntheticConfig(batch_size=bsz, seed=args.seed + 93))
                   .batches(nsteps + 4))
    out = {}
    for name, force, ragged in (("fast", False, False), ("dense", True, False),
                                ("ragged", True, True)):
        st.FORCE_EXCHANGE = force
        tr = ShardedTrainer(RunConfig(batch_size=bsz, steps=nsteps, seed=args.seed,
                                      pipeline_depth=0, a2a_ragged=ragged), cfg, ModelConfig(),
                            mesh=mesh, generator=torch.Generator().manual_seed(args.seed + 95))
        c0 = tr.counters()
        out[name] = run_steps(f"sharded {name}", lambda b: tr.train_step(b)["loss"],
                              batches[:nsteps], dev, card, SHARDED_LAUNCHES[name])
        c1 = tr.counters()
        check_drops(f"sharded {name}", c0, c1)
        if c1["route_drops"]:
            raise AssertionError(f"sharded {name}: {c1['route_drops']} route drops at S = 1")
        log(f"sharded {name}: route drops 0; {tr.spec.capacity}-slot table, {len(tr)} rows")
        if not rehearse:
            run_profiled(f"sharded {name}", lambda: [tr.train_step(b) for b in batches[nsteps:]],
                         4, "step")
        del tr
    st.FORCE_EXCHANGE = True
    fast = out["fast"]["p50_ms"]
    log(f"sharded: the exchange's tax at S = 1, step p50 over the fast path's {fast:.3f} ms: "
        f"dense +{out['dense']['p50_ms'] - fast:.3f} ms, ragged "
        f"+{out['ragged']['p50_ms'] - fast:.3f} ms on {card}")
    return out


def sharded_serving(args, res, mesh, dev, card: str) -> dict:
    """Part c: a ShardedScoringService on the serve phase's checkpoint,
    against an f32 ScoringService on it."""
    rehearse = dev.type == "cpu"
    cfg = TableConfig(dim=32, capacity=args.capacity if rehearse else SHARDED_SERVE_CAP)
    mc = ModelConfig()
    ckpt = str(res["ckpt"])
    sync(dev)
    t0 = time.perf_counter()
    svc = ShardedScoringService(ckpt, cfg, mc, mesh=mesh)
    sync(dev)
    restore_s = time.perf_counter() - t0
    if len(svc) != args.ckpt_rows:
        raise AssertionError(f"the sharded service restored {len(svc)} rows of {args.ckpt_rows}")
    ref = ScoringService(ckpt, cfg, mc, device=dev)
    rng = np.random.default_rng(args.seed + 97)
    nd, ns = mc.num_dense_features, mc.num_sparse_features
    reqs = [(rng.standard_normal((args.batch, nd), dtype=np.float32),
             make_request(rng, [res["written"]["ids"]], args.batch, ns))
            for _ in range(args.requests + 3)]
    for dense, ids in reqs[:3]:  # warm-up
        svc.score(dense, ids)
    lat, gap = [], 0.0
    for dense, ids in reqs[3:]:
        at = launches()
        t0 = time.perf_counter()
        p = svc.score(dense, ids)
        lat.append((time.perf_counter() - t0) * 1e3)
        got = _launch_delta(at)
        if dev.type == "cuda" and got != {**{k: 0 for k in got},
                                          "row_gather": SHARDED_REQUEST_GATHERS,
                                          "bucket_probe": SHARDED_REQUEST_PROBES}:
            raise AssertionError(f"a sharded request launched {got}, not "
                                 f"{SHARDED_REQUEST_GATHERS} row_gather, "
                                 f"{SHARDED_REQUEST_PROBES} bucket_probe and nothing else")
        want = ref.score(dense, ids)
        np.testing.assert_allclose(p, want, rtol=1e-6, atol=0)
        gap = max(gap, float(np.abs(p - want).max()))
    lat = np.asarray(lat)
    log(f"sharded serve: restored {len(svc)} rows into a {cfg.capacity}-slot shard in "
        f"{_ms(restore_s)}; {len(lat)} requests of {args.batch} x {ns} ids (10% unknown): p50 "
        f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, "
        f"{args.batch * ns * len(lat) / (lat.sum() / 1e3):.0f} ids/s on {card}; "
        f"{SHARDED_REQUEST_GATHERS} row_gather and {SHARDED_REQUEST_PROBES} bucket_probe a "
        f"request; scores equal the f32 ScoringService's "
        f"within rtol 1e-6 (max |diff| {gap}); route drops {svc.route_drops}")
    dense, ids = reqs[3]
    body = {"dense": dense.tolist(), "ids": ids.tolist()}
    http = serving(svc, lambda s: post_json(s, "/score", body))["scores"]
    np.testing.assert_allclose(http, svc.score(dense, ids), atol=1e-6)
    log("sharded serve: POST /score matches the direct score")
    return {"p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99))}


def sharded_lifecycle(args, mesh, dev, card: str) -> None:
    """Part d, at reduced depth: eviction into a HostKVStore with promotion
    back, remove, growth, and a checkpoint over the multi-process protocol
    restored into a ShardedTrainer and into a Trainer."""
    rehearse = dev.type == "cpu"
    bsz = args.batch if rehearse else TRAIN_BATCH
    cap = 1 << 14 if rehearse else SHARDED_LIFE_CAP
    policy = PolicyConfig(evict_policy="lfu_ttl", ttl_steps=4, lfu_min_freq=2,
                          max_evict_per_pass=cap // 8, evict_scan_buckets=cap // LANES // 4)
    cfg = TableConfig(dim=32, capacity=cap, policy=policy)
    store = HostKVStore(SpillCodec(TableSpec.from_config(cfg)).width)
    run_cfg = RunConfig(batch_size=bsz, steps=12, seed=args.seed, pipeline_depth=0)
    tr = ShardedTrainer(run_cfg, cfg, ModelConfig(), mesh=mesh, spill=store,
                        generator=torch.Generator().manual_seed(args.seed + 99))
    batches = list(SyntheticStream(SyntheticConfig(batch_size=bsz, seed=args.seed + 101,
                                                   drift_per_step=500)).batches(12))
    evicted = 0
    for i, b in enumerate(batches):
        tr.train_step(b)
        if i % 4 == 3:
            evicted += tr.maintenance()["evicted"]
    c = tr.counters()
    if not (evicted > 0 and evicted == c["evictions"] == c["spills"]
            and 0 < len(store) <= evicted):
        raise AssertionError(f"sharded evicted {evicted}, counters {c}, store {len(store)}")

    # promotion: spilled ids, looked up again, come back with their payload
    n_prom = min(len(store), bsz, 1024)
    keys = next(store.export())[0][:n_prom]
    want, _ = store.lookup_batch(keys)
    b = dict(batches[-1])
    b["ids"] = b["ids"].copy()
    b["ids"][:n_prom, 0] = keys
    tr.train_step(b)  # the misses on their owner feed its promoter
    tr.flush()
    tr._promoter.flush()
    m = tr.maintenance()
    rows = tr.shard.values[_slots(tr, keys)].cpu().numpy()
    if m["promoted"] < n_prom or not np.array_equal(rows.view(np.int32),
                                                    want[:, :32].view(np.int32)):
        raise AssertionError(f"sharded promotion: {m['promoted']} promoted of {n_prom}")
    gone = keys[:n_prom // 2]
    removed = tr.remove(np.concatenate([gone, [-5]]))
    if removed != len(gone) or bool(_found(tr.spec, tr.shard,
                                           torch.from_numpy(gone).to(dev)).any()):
        raise AssertionError(f"sharded remove: {removed} of {len(gone)}")
    log(f"sharded lifecycle: 12 steps of {bsz} x 26 ids, maintenance every 4: evicted and "
        f"spilled {evicted} rows; {n_prom} spilled ids promoted back with their payload bit for "
        f"bit; remove (exchange_erase) of {len(gone)} ids (+1 absent): {removed} removed")

    # growth at grow_at_load keeps every earlier row
    gcfg = TableConfig(dim=32, capacity=cap // 4, grow_at_load=0.6)
    gt = ShardedTrainer(run_cfg, gcfg, ModelConfig(), mesh=mesh,
                        generator=torch.Generator().manual_seed(args.seed + 103))
    for i, b in enumerate(batches):
        before = export_shard_arrays(gt.spec, gt.shard)
        cap0 = gt.spec.capacity
        gt.train_step(b)
        if gt.spec.capacity > cap0:
            break
    else:
        raise AssertionError(f"the grow_at_load table never grew from {gcfg.capacity} slots")
    after = export_shard_arrays(gt.spec, gt.shard)
    untouched = ~np.isin(before["ids"], b["ids"].reshape(-1))
    keep = np.isin(after["ids"], before["ids"][untouched])
    if not np.isin(before["ids"], after["ids"]).all() or int(keep.sum()) != int(untouched.sum()):
        raise AssertionError("sharded growth lost rows")
    _same_rows({k: v[keep] for k, v in after.items()},
               {k: v[untouched] for k, v in before.items()}, "sharded growth")
    log(f"sharded lifecycle: growth at step {i}: {cap0} -> {gt.spec.capacity} slots with "
        f"{before['ids'].shape[0]} earlier rows kept ({int(untouched.sum())} the step did not "
        f"touch bit for bit)")
    del gt

    # checkpoint over the multi-process protocol -> ShardedTrainer and Trainer
    root = ROOT / "build" / "chip_smoke" / "sharded"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        m = tr.save_checkpoint(str(root))
        save_s = time.perf_counter() - t0
        want = export_shard_arrays(tr.spec, tr.shard)
        dense = [*to_jax_params(tr.model)]
        plain_cfg = TableConfig(dim=32, capacity=cap)
        for name, back in (("ShardedTrainer", ShardedTrainer(run_cfg, cfg, ModelConfig(),
                                                             mesh=mesh)),
                           ("Trainer", Trainer(run_cfg, plain_cfg, ModelConfig(), device=dev))):
            got_m = back.load_checkpoint(str(root))
            if got_m["step"] != tr.step:
                raise AssertionError(f"{name} restored step {got_m['step']}, saved {tr.step}")
            _same_rows(export_shard_arrays(back.spec, back.shard), want, f"sharded -> {name}")
            for x, y in zip(to_jax_params(back.model), dense, strict=True):
                if not np.array_equal(x, y):
                    raise AssertionError(f"sharded -> {name}: a dense leaf differs")
            for x, y in zip(to_jax_adam_state(back.opt_state, back.model),
                            to_jax_adam_state(tr.opt_state, tr.model), strict=True):
                if not np.array_equal(x, y):
                    raise AssertionError(f"sharded -> {name}: an Adam leaf differs")
            del back
        log(f"sharded lifecycle: save_checkpoint of {sum(m['counts'])} rows over the "
            f"multi-process protocol in {_ms(save_s)}; restored into a ShardedTrainer and a "
            f"Trainer with every row and dense leaf equal, bit for bit")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _slots(tr, keys) -> torch.Tensor:
    """The slots of ids that must be in a trainer's shard."""
    hi, lo = hashing.split_ids_t(torch.from_numpy(np.asarray(keys, np.int64)).to(tr.device))
    pr = table_ops.probe(tr.spec, tr.shard, hi, lo, hashing.is_valid(hi, lo))
    if not bool(pr.found.all()):
        raise AssertionError(f"{int((~pr.found).sum())} ids are not in the shard")
    return pr.slot.long()


def sharded_phase(args, res, dev, card: str) -> dict:
    """The sharded phase (module docstring), on a world of one with
    FORCE_EXCHANGE on; the process group is destroyed at its end."""
    mesh = make_mesh(device=dev)
    meshes = {"cpu": make_mesh(device="cpu"), "card": mesh}
    out = {}
    try:
        st.FORCE_EXCHANGE = True
        out["parity"] = check_sharded_parity(args.seed, meshes, dev)
        out["steps"] = sharded_steps(args, mesh, dev, card)
        out["serve"] = sharded_serving(args, res, mesh, dev, card)
        sharded_lifecycle(args, mesh, dev, card)
    finally:
        st.FORCE_EXCHANGE = False
        pmesh.destroy()
    return out


# --- table groups --------------------------------------------------------------------

GROUP_FEATURES = ["user", "item", "item"] + ["ctx"] * 23  # config 2's 26 columns, 3 members
GROUP_CAPS = {"user": 1 << 24, "item": 1 << 24, "ctx": 1 << 25}


def group_cfgs(caps: dict, user=None, item=None) -> dict:
    """user ids at dim 64 with rowwise AdaGrad, item ids (columns 1-2, one
    shared table) at dim 32 with FTRL, the 23 context columns at dim 32 with
    rowwise AdaGrad. `user`/`item`: extra TableConfig fields."""
    return {
        "user": TableConfig(dim=64, capacity=caps["user"], **(user or {}),
                            optimizer=OptimizerConfig(kind="rowwise_adagrad")),
        "item": TableConfig(dim=32, capacity=caps["item"], **(item or {}),
                            optimizer=OptimizerConfig(kind="ftrl")),
        "ctx": TableConfig(dim=32, capacity=caps["ctx"],
                           optimizer=OptimizerConfig(kind="rowwise_adagrad")),
    }


def member_launches(kind: str) -> dict:
    """One member's launches in a group step, planning rounds aside: the
    probe (1 bucket_probe), the values read and the rows by the inverse (2
    gathers), the fresh keys' set, the segment sum's walk and combine (2
    K1); then rowwise AdaGrad's fetch-add and values add, or FTRL's fresh
    rows' init add, one gather of z, n and values, and their 3 adds."""
    want = {"row_scatter_set": 1, "row_scatter_add": 0, "row_merge_add": 2, "row_gather": 2,
            "bucket_probe": 1}
    if kind == "rowwise_adagrad":
        want["row_scatter_add"] += 1
        want["row_merge_add"] += 1
    elif kind == "ftrl":
        want["row_merge_add"] += 4
        want["row_gather"] += 1
    else:
        raise ValueError(f"no launch count for {kind!r}")
    return want


def group_launches(cfgs: dict) -> dict:
    total = {k: 0 for k in TRAIN_STEP_LAUNCHES}
    for cfg in cfgs.values():
        for k, v in member_launches(cfg.optimizer.kind).items():
            total[k] += v
    return total


def group_phase(args, dev, card: str) -> dict:
    """The group phase (module docstring)."""
    rehearse = dev.type == "cpu"
    bsz = args.batch if rehearse else TRAIN_BATCH
    nsteps = 3 if rehearse else 5 + TRAIN_STEPS
    mc = ModelConfig(kind="ctr_mlp")  # 13 dense, 26 sparse, top 256-128-1
    small = {"user": 1 << 12, "item": 1 << 12, "ctx": 1 << 13}
    caps = small if rehearse else GROUP_CAPS
    out = {}

    # (a) 3 steps on the card and on the CPU from one state
    pcaps = {"user": 1 << 16, "item": 1 << 16, "ctx": 1 << 17}
    pb = list(SyntheticStream(SyntheticConfig(batch_size=512, seed=args.seed + 71)).batches(3))
    runs = {}
    for d in (torch.device("cpu"), dev):
        tr = GroupTrainer(RunConfig(batch_size=512, steps=3, seed=args.seed), group_cfgs(pcaps),
                          GROUP_FEATURES, mc, device=d,
                          generator=torch.Generator().manual_seed(args.seed + 73))
        runs[d.type] = (tr, [tr.train_step(b)["loss"] for b in pb])
    (ctr, closs), (gtr, gloss) = runs["cpu"], runs[dev.type]
    errs = {n: planes_agree(f"group parity {n}", gtr.shards[n], ctr.shards[n])
            for n in ctr.names}
    np.testing.assert_allclose(gloss, closs, rtol=1e-5, atol=1e-6)
    log(f"check group parity: 3 steps of 512 x 26 ids over members {ctr.names}, {dev} vs CPU: "
        f"planes and counters equal; max |{dev} - CPU| {errs}; losses {gloss}")
    del runs, ctr, gtr

    # (b) steps of 4096 examples at config 2's widths
    cfgs = group_cfgs(caps)
    tr = GroupTrainer(RunConfig(batch_size=bsz, steps=nsteps, seed=args.seed), cfgs,
                      GROUP_FEATURES, mc, device=dev,
                      generator=torch.Generator().manual_seed(args.seed + 75))
    gib = sum(t.numel() * t.element_size() for n in tr.names
              for t in _planes(tr.shards[n])) / 2**30
    want = group_launches(cfgs)
    log(f"group: members " + ", ".join(
        f"{n} (dim {cfgs[n].dim}, {cfgs[n].optimizer.kind}, {tr.specs[n].capacity} slots, "
        f"columns {tr.table_features[n][0]}-{tr.table_features[n][-1]}: launches a step "
        f"{member_launches(cfgs[n].optimizer.kind)} + rounds)" for n in tr.names)
        + f"; state {gib:.2f} GiB on {dev}")
    batches = list(SyntheticStream(SyntheticConfig(batch_size=bsz, seed=args.seed + 77))
                   .batches(nsteps + 3))  # 2 to profile, 1 for the timings
    c0 = {n: dict(c) for n, c in tr.counters().items()}
    out["steps"] = run_steps("group", lambda b: tr.train_step(b)["loss"], batches[:-3], dev,
                             card, want)
    c1 = tr.counters()
    for n in tr.names:
        check_drops(f"group {n}", c0[n], c1[n])
    out["lifecycle"] = group_lifecycle(args, dev, card, mc)
    out["trainer"], out["spare"] = tr, batches[-3:]  # profiled and timed outside the phase
    return out


def group_lifecycle(args, dev, card: str, mc) -> dict:
    """At reduced depth on a 2^20-slot group: LFU/TTL eviction of the user
    member into a HostKVStore, promotion back, remove, growth of the item
    member at grow_at_load; then a checkpoint that a GroupScoringService
    restores and scores as the trainer's eval_step."""
    rehearse = dev.type == "cpu"
    bsz = args.batch if rehearse else TRAIN_BATCH
    cap = 1 << 14 if rehearse else 1 << 20
    policy = PolicyConfig(evict_policy="lfu_ttl", ttl_steps=4, lfu_min_freq=2,
                          max_evict_per_pass=cap // 8, evict_scan_buckets=cap // LANES // 4)
    item_cap = cap // 64
    cfgs = group_cfgs({"user": cap, "item": item_cap, "ctx": cap}, user={"policy": policy},
                      item={"grow_at_load": 0.6})
    store = HostKVStore(SpillCodec(TableSpec.from_config(cfgs["user"])).width)
    run_cfg = RunConfig(batch_size=bsz, steps=12, seed=args.seed)
    tr = GroupTrainer(run_cfg, cfgs, GROUP_FEATURES, mc, spill={"user": store}, device=dev,
                      generator=torch.Generator().manual_seed(args.seed + 79))
    stream = SyntheticStream(SyntheticConfig(batch_size=bsz, seed=args.seed + 81,
                                             drift_per_step=500))
    batches = list(stream.batches(13))  # 12 steps, 1 held out for scoring
    evicted, pass_s = 0, []
    for i, b in enumerate(batches[:12]):
        tr.train_step(b)
        if i % 4 == 3:
            t0 = time.perf_counter()
            m = tr.maintenance()
            sync(dev)
            pass_s.append(time.perf_counter() - t0)
            evicted += m["user"]["evicted"]
            if m["item"]["evicted"] or m["ctx"]["evicted"]:
                raise AssertionError(f"members without a policy evicted: {m}")
    c = tr.counters()
    # spilled ids seen again are promoted back at the next tick, and erased
    # from the store
    if not (evicted > 0 and evicted == c["user"]["evictions"] == c["user"]["spills"]
            and 0 < len(store) <= evicted):
        raise AssertionError(f"evicted {evicted}, counters {c['user']}, store {len(store)}")
    if tr.specs["item"].capacity <= item_cap or any(c[n]["drops"] for n in c):
        raise AssertionError(f"the item member did not grow, or a member dropped: {c}")
    log(f"group lifecycle: 12 steps of {bsz} x 26 ids, maintenance every 4 "
        f"({_ms(float(np.median(pass_s)))} p50): user evicted and spilled {evicted} rows "
        f"(store {len(store)}, {c['user']['promotes']} promoted back); item grew "
        f"{item_cap} -> {tr.specs['item'].capacity} slots with {c['item']['rows']} rows; "
        f"drops 0")

    # promotion: spilled user ids, looked up again, come back with their payload
    n_prom = min(len(store), bsz, 1024)
    keys = next(store.export())[0][:n_prom]
    want, _ = store.lookup_batch(keys)
    b = dict(batches[11])
    b["ids"] = b["ids"].copy()
    b["ids"][:n_prom, 0] = keys
    tr.train_step(b)  # misses feed the user member's promoter
    tr._promoters["user"].flush()
    t0 = time.perf_counter()
    m = tr.maintenance()
    sync(dev)
    hi, lo = hashing.split_ids(keys)
    spec, shard = tr.specs["user"], tr.shards["user"]
    pr = table_ops.probe(spec, shard, torch.from_numpy(hi).to(dev),
                         torch.from_numpy(lo).to(dev), torch.ones(n_prom, dtype=torch.bool,
                                                                  device=dev))
    rows = shard.values[pr.slot.clamp(min=0).long()].cpu().numpy()
    if (m["user"]["promoted"] < n_prom or not bool(pr.found.all())
            or not np.array_equal(rows.view(np.int32), want[:, :spec.dim].view(np.int32))):
        raise AssertionError(f"promotion: {m['user']['promoted']} promoted of {n_prom}, "
                             f"{int(pr.found.sum())} found, rows equal "
                             f"{np.array_equal(rows, want[:, :spec.dim])}")
    log(f"group lifecycle: {n_prom} spilled user ids promoted back in "
        f"{_ms(time.perf_counter() - t0)}; rows equal their spilled payload bit for bit")

    # remove: half of the promoted ids and an absent one
    gone = keys[:n_prom // 2]
    removed = tr.remove("user", np.concatenate([gone, [-5]]))
    if removed != len(gone) or bool(_found(spec, shard, torch.from_numpy(gone).to(dev)).any()):
        raise AssertionError(f"remove: {removed} of {len(gone)}")
    log(f"group lifecycle: remove of {len(gone)} user ids (+1 absent): {removed} removed, "
        f"none found after")

    # checkpoint -> GroupScoringService: its scores are the trainer's eval_step's
    root = ROOT / "build" / "chip_smoke" / "group"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        tr.save_checkpoint(str(root))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc = GroupScoringService(str(root), run_cfg, cfgs, GROUP_FEATURES, mc, device=dev)
        sync(dev)
        load_s = time.perf_counter() - t0
        held = batches[12]
        got = svc.score(held["dense"], held["ids"])
        logits = tr.eval_step(held)["logits"].cpu().numpy().astype(np.float64)
        want_p = (1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
        np.testing.assert_allclose(got, want_p, rtol=1e-6, atol=0)
        http = serving(svc, lambda s: post_json(s, "/score", {
            "dense": held["dense"][:64].tolist(), "ids": held["ids"][:64].tolist()}))
        np.testing.assert_allclose(http["scores"], got[:64], atol=1e-6)
        if svc.stats()["tables"] != {n: c["rows"] for n, c in tr.counters().items()}:
            raise AssertionError(f"restored rows {svc.stats()} differ from the trainer's")
        log(f"group lifecycle: saved in {save_s:.2f} s, restored into a GroupScoringService "
            f"in {load_s:.2f} s ({svc.stats()['rows']} rows); its scores of {len(got)} "
            f"examples equal the trainer's eval_step probabilities (max |diff| "
            f"{float(np.abs(got - want_p).max())}); POST /score matches")
    finally:
        shutil.rmtree(root.parent, ignore_errors=True)
    return {"evicted": evicted, "promoted": m["user"]["promoted"], "removed": removed}


def time_group_kernels(tr, batch, seed: int) -> list:
    """The group members' new call shapes, on the slots of one step's unique
    ids (shifted by multiples of a bucket, 8 sets): the user member's
    [2^24, 64] values gather and add, and the FTRL item member's gather of
    z, n and values and its add into z."""
    dev = tr.device
    g = torch.Generator(device=dev).manual_seed(seed + 83)
    tr.train_step(batch)
    hi, lo = hashing.split_ids_t(torch.from_numpy(batch["ids"]).to(dev))
    out = []
    for n in ("user", "item"):
        spec, shard = tr.specs[n], tr.shards[n]
        cols = tr._cols[n]
        h, l = hi.index_select(1, cols).reshape(-1), lo.index_select(1, cols).reshape(-1)
        uniq = dedup.unique_pairs(h, l, h.shape[0])
        pr = table_ops.probe(spec, shard, uniq.hi, uniq.lo, uniq.valid)
        ok, C, W = pr.found, spec.capacity, spec.dim
        T, m = int(ok.sum()), ok.shape[0]
        shifts = [((pr.slot.long() + k * 7919 * LANES) % C) for k in range(8)]
        vrows = [torch.where(ok, s, -1).to(torch.int32) for s in shifts]
        vrow64 = [s[ok] for s in shifts]
        planes = [shard.values] if n == "user" else [*shard.opt_fulldim, shard.values]
        label = "user values" if n == "user" else "item FTRL z, n, values"
        out.append(("row_gather", gather_entry(f"group {label} per step",
                                               planes[0] if len(planes) == 1 else planes,
                                               [v.clamp(min=0) for v in vrows])))
        plane = planes[0]
        zero = torch.zeros((m, W), device=dev)

        def check(plane=plane, vr=vrows[:2], m=m, W=W):
            got, want = plane.clone(), plane.clone()
            for i in vr:
                upd = torch.randn((m, W), device=dev, generator=g) * 1e-3
                row_merge_add(got, i, upd)
                row_merge_add_plain(want, i, upd)
            return max_abs_err("row_merge_add", got, want)

        out.append(("row_merge_add", entry(
            f"group {'user values' if n == 'user' else 'item FTRL z'} add per step",
            f"{tuple(plane.shape)} {plane.dtype}, m={m} ({T} valid rows)",
            4 * m + 4 * W * T + 2 * T * W * plane.element_size(),
            [lambda v=v, p=plane, z=zero: row_merge_add(p, v, z) for v in vrows],
            [lambda v=v, p=plane, z=zero: row_merge_add_plain(p, v, z) for v in vrows],
            [lambda v=v, p=plane, z=zero[:T]: p.index_add_(0, v, z) for v in vrow64],
            check, "add_unique")))
    return out

# --- the column-sharded table (two ranks on one card) ---------------------------------

COL_DIM, COL_C = 256, 2  # README's wide table: dim 256 over C = 2 column blocks of 128 lanes
COL_CAP = 1 << 24  # slots a rank: 8 GiB of f32 values at 128 lanes
COL_SMALL_CAP = 1 << 16  # the small copy held against a single-device Trainer
COL_STEPS = 30  # timed steps, after 5 warm-up
COL_PROMOTE = 1024  # spilled ids trained again and promoted back
# LFU/TTL keeps scores: a step launches the lifecycle's (touch adds a set and
# a K3 add); the column collectives launch no kernel. An eviction pass: 3
# gathers (the window, the export's bucket planes, its rows) and 2 sets.
COL_STEP_LAUNCHES = {"row_scatter_set": 2, "row_scatter_add": 2, "row_merge_add": 3,
                     "row_gather": 2, "bucket_probe": 1}
COL_PASS_LAUNCHES = {"row_scatter_set": 2, "row_scatter_add": 0, "row_merge_add": 0,
                     "row_gather": 3, "bucket_probe": 0}


def col_configs(args, rehearse: bool):
    """(run, the main table, the small copy, model) of the colsharded phase."""
    bsz = args.batch if rehearse else TRAIN_BATCH
    cap = args.capacity if rehearse else COL_CAP
    policy = PolicyConfig(evict_policy="lfu_ttl", ttl_steps=4, lfu_min_freq=2,
                          max_evict_per_pass=1 << 14 if not rehearse else cap // 8,
                          evict_scan_buckets=cap // LANES // 8)
    opt = OptimizerConfig(kind="rowwise_adagrad")
    table = TableConfig(dim=COL_DIM, capacity=cap, optimizer=opt, policy=policy)
    small = TableConfig(dim=COL_DIM, capacity=1 << 13 if rehearse else COL_SMALL_CAP,
                        optimizer=opt)
    run = RunConfig(batch_size=bsz, steps=3 if rehearse else 5 + COL_STEPS, seed=args.seed,
                    pipeline_depth=0)
    return run, table, small, ModelConfig(kind="ctr_mlp", embedding_dim=COL_DIM)


def _rows_by_id(parts) -> dict:
    """{id: (values row, freq, accum)} of checkpoint row dicts."""
    out = {}
    for p in parts:
        for j, k in enumerate(p["ids"].tolist()):
            out[k] = (p["values"][j], int(p["freq"][j]), float(p["accum"][j]))
    return out


def col_small_copy(mesh2d, run, small, mc, batches, dev, root: Path) -> None:
    """Part a on the small copy: the grid against a single-device Trainer on
    the card (rank 0), then the grid's checkpoint restored into a Trainer
    with bit-equal rows."""
    seed = run.seed + 103
    grid = ColShardedTrainer(run, small, mc, mesh2d, device=dev,
                             generator=torch.Generator().manual_seed(seed))
    losses = [grid.train_step(b)["loss"] for b in batches]
    ck = root / "small"
    grid.save_checkpoint(str(ck))
    rank = mesh2d.world.rank
    if rank == 0:
        single = Trainer(run, small, mc, device=dev,
                         generator=torch.Generator().manual_seed(seed))
        want = [single.train_step(b)["loss"] for b in batches]
        np.testing.assert_allclose(losses, want, rtol=2e-3, atol=2e-4)
        merged = _rows_by_id(ckpt_io.iter_rows(str(ck)))
        mine = _rows_by_id([export_shard_arrays(single.spec, single.shard)])
        if set(merged) != set(mine):
            raise AssertionError("the grid and the single-device Trainer hold other ids")
        ids = sorted(mine)
        got = np.stack([merged[i][0] for i in ids])
        ref = np.stack([mine[i][0] for i in ids])
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
        restored = Trainer(run, small, mc, device=dev)
        restored.load_checkpoint(str(ck))
        back = _rows_by_id([export_shard_arrays(restored.spec, restored.shard)])
        for i in ids:
            a, b = back[i], merged[i]
            if not (np.array_equal(a[0].view(np.int32), b[0].view(np.int32))
                    and a[1:] == b[1:]):
                raise AssertionError(f"restored row {i} differs from the grid's")
        log(f"colsharded small copy: {len(batches)} steps of {batches[0]['ids'].shape} ids on a "
            f"{small.capacity}-slot 1 x 2 grid; losses {losses} vs a single-device Trainer's "
            f"{want} (rtol 2e-3); {len(ids)} merged rows within rtol 2e-3 (max |diff| "
            f"{float(np.abs(got - ref).max())}); its 2-D checkpoint restored into a Trainer "
            f"with every row, freq and accumulator bit-equal")
    multihost.barrier("colsharded small copy", mesh2d.world)


def _col_blocks(tr, keys) -> torch.Tensor:
    """The full rows of `keys` on every rank: this rank's blocks all-gathered
    over the column."""
    slots = _slots(tr, keys)
    return tr._full_rows(tr.shard.values[slots].contiguous())


def col_rank_main(args) -> int:
    """One rank of the colsharded phase (`--col-rank`): the small copy, then
    the main path with the counters set to 0 just before it; prints its
    results as the last JSON line."""
    rehearse = args.rehearse_on_cpu
    if rehearse:
        cap_cpu_threads()
    dev = torch.device("cpu" if rehearse else "cuda")
    root = Path(args.col_dir)
    rank = args.col_rank
    pmesh.init_distributed("gloo", f"file://{root / 'store'}", rank, COL_C, device=dev)
    try:
        mesh2d = pmesh.make_mesh2d(1, COL_C, device=dev)
        run, table, small, mc = col_configs(args, rehearse)
        nsteps = run.steps
        batches = list(SyntheticStream(SyntheticConfig(
            batch_size=run.batch_size, seed=args.seed + 101, drift_per_step=500))
            .batches(nsteps + 5))
        col_small_copy(mesh2d, run, small, mc, batches[:3], dev, root)

        # the main path
        reset_launches()
        store = HostKVStore(SpillCodec(TableSpec.from_config(table)).width) if rank == 0 else None
        tr = ColShardedTrainer(run, table, mc, mesh2d, spill=store, device=dev,
                               generator=torch.Generator().manual_seed(args.seed + 105))
        c0 = tr.counters()
        card = f"rank {rank} of a 1 x {COL_C} grid"
        steps = run_steps(f"colsharded {card}", lambda b: tr.train_step(b)["loss"],
                          batches[:nsteps], dev, card, COL_STEP_LAUNCHES)
        # the column collectives' share of a step, on 4 more steps timed apart
        coll = [0.0]

        def timed(fn):
            def call(x):
                sync(dev)
                t0 = time.perf_counter()
                y = fn(x)
                sync(dev)
                coll[0] += time.perf_counter() - t0
                return y
            return call

        tr._full_rows, tr._g2_mean = timed(tr._full_rows), timed(tr._g2_mean)
        t0 = time.perf_counter()
        for b in batches[nsteps:nsteps + 4]:
            tr.train_step(b)
        sync(dev)
        inst_s = time.perf_counter() - t0
        del tr._full_rows, tr._g2_mean
        share = coll[0] / inst_s
        log(f"colsharded {card}: the column collectives (all_gather of the [U, 128] blocks, "
            f"all_reduce of the [U] sums of squares; gloo, staged through the host) take "
            f"{1e3 * coll[0] / 4:.3f} ms of a {1e3 * inst_s / 4:.3f} ms instrumented step "
            f"({100 * share:.1f}%)")

        # an eviction pass: column 0 spills full-dim rows
        at = launches()
        t0 = time.perf_counter()
        evicted = tr.maintenance()["evicted"]
        sync(dev)
        pass_ms = (time.perf_counter() - t0) * 1e3
        pass_launches = _launch_delta(at)
        if not rehearse and pass_launches != COL_PASS_LAUNCHES:
            raise AssertionError(f"an eviction pass launched {pass_launches}")
        if evicted <= 0 or (store is not None and len(store) != evicted):
            raise AssertionError(f"evicted {evicted}, spill tier {store and len(store)}")

        # promotion: spilled ids trained again come back, read back full-dim
        keys = torch.zeros((min(COL_PROMOTE, evicted, run.batch_size),), dtype=torch.int64,
                           device=dev)
        payload = None
        if store is not None:
            k = next(store.export())[0][:keys.shape[0]]
            keys.copy_(torch.from_numpy(k))
            payload, _ = store.lookup_batch(k)
        tr._col_broadcast(keys)
        keys_np = keys.cpu().numpy()
        b = dict(batches[nsteps + 4])
        b["ids"] = b["ids"].copy()
        b["ids"][:len(keys_np), 0] = keys_np
        tr.train_step(b)
        tr.flush()
        if tr._promoter is not None:
            tr._promoter.flush()
        pst = tr._apply_promotions()  # the promotion half of maintenance()
        rows = _col_blocks(tr, keys_np).cpu().numpy()
        acc = tr.shard.opt_rowwise[0].view(-1)[_slots(tr, keys_np)].cpu().numpy()
        if pst.inserted < len(keys_np) or payload is not None and not (
                np.array_equal(rows.view(np.int32), payload[:, :COL_DIM].view(np.int32))
                and np.array_equal(acc.view(np.int32), payload[:, COL_DIM + 1].view(np.int32))):
            raise AssertionError(f"promotion: {pst} for {len(keys_np)} spilled ids")
        counts = launches()
        c1 = tr.counters()
        if c1["drops"] - c0["drops"] or c1["route_drops"]:
            raise AssertionError(f"colsharded drops: {c1}")
        h = hashlib.sha256()
        s = tr.shard
        for p in (s.key_hi, s.key_lo, s.cnt, s.ovf, s.freq, s.last, s.opt_rowwise[0],
                  s.counters):
            h.update(p.cpu().numpy().tobytes())
        log(f"colsharded {card}: eviction pass {pass_ms:.1f} ms, {evicted} rows evicted"
            + (f" and spilled full-dim ({len(store)} in the store)" if store else "")
            + f"; {len(keys_np)} spilled ids trained again, {pst.inserted} rows promoted back; "
            f"their full rows and accumulators equal the payloads bit for bit; rows {len(tr)}; drops 0, route drops 0; "
            f"launches {counts}")
        print(json.dumps({"rank": rank, "launches": counts, "p50_ms": steps["p50_ms"],
                          "p99_ms": steps["p99_ms"], "examples_per_s": steps["examples_per_s"],
                          "collective_share": share, "collective_ms": 1e3 * coll[0] / 4,
                          "instrumented_step_ms": 1e3 * inst_s / 4, "evicted": evicted,
                          "promoted": pst.inserted, "rows": len(tr), "digest": h.hexdigest(),
                          "loss_first": steps["loss_first"], "loss_last": steps["loss_last"]}),
              flush=True)
    finally:
        pmesh.destroy()
    return 0


def colsharded_phase(args, dev, card: str) -> dict:
    """The colsharded phase (module docstring): two rank processes of this
    script on one card in a gloo group; their lines are relayed here.
    Returns the launches summed over the ranks, and the ranks' results."""
    rehearse = dev.type == "cpu"
    root = ROOT / "build" / "chip_smoke" / "col"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--seed", str(args.seed),
           "--batch", str(args.batch), "--capacity", str(args.capacity),
           "--col-dir", str(root)] + (["--rehearse-on-cpu"] if rehearse else [])
    procs = [subprocess.Popen(cmd + ["--col-rank", str(r)], stdout=subprocess.PIPE, text=True,
                              cwd=str(ROOT)) for r in range(COL_C)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(root, ignore_errors=True)
    res = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = out.splitlines()
        for line in lines:
            if not line.startswith("{"):
                log(f"colsharded rank {r} | {line}")
        if p.returncode != 0:
            raise AssertionError(f"colsharded rank {r} exited {p.returncode}")
        res.append(json.loads([x for x in lines if x.startswith("{")][-1]))
    if len({r["digest"] for r in res}) != 1:
        raise AssertionError("the columns' key planes, cnt, freq, last and accumulator differ")
    total = {k: sum(r["launches"][k] for r in res) for k in res[0]["launches"]}
    log(f"colsharded: a 1 x {COL_C} grid of dim {COL_DIM} ({COL_DIM // COL_C} lanes a rank) on "
        f"one card over gloo: step p50 " + ", ".join(f"{r['p50_ms']:.3f}" for r in res)
        + " ms, p99 " + ", ".join(f"{r['p99_ms']:.3f}" for r in res) + " ms a rank; column "
        f"collectives " + ", ".join(f"{100 * r['collective_share']:.1f}%" for r in res)
        + f" of an instrumented step (gloo through the host; NVLink not measured); key "
        f"planes, cnt, freq, last and accumulator bit-identical across the columns; "
        f"launches {total} on {card}")
    return {"launches": total, "ranks": res}


def time_col_kernels(args, seed: int) -> list:
    """The column block's shapes: a step's 128-lane values gather and add on
    a [2^24, 128] f32 plane at the slots of one step of the colsharded
    phase's ids, and the gradient segment sum of that step at 128 lanes."""
    run, _, _, mc = col_configs(args, False)
    cfg = TableConfig(dim=COL_DIM // COL_C, capacity=COL_CAP,
                      optimizer=OptimizerConfig(kind="rowwise_adagrad"))
    tr = Trainer(run, cfg, dataclasses.replace(mc, embedding_dim=cfg.dim), device="cuda",
                 generator=torch.Generator().manual_seed(seed + 107))
    batch = next(iter(SyntheticStream(SyntheticConfig(batch_size=run.batch_size,
                                                      seed=args.seed + 101)).batches(1)))
    dev, shard, spec = tr.device, tr.shard, tr.spec
    g = torch.Generator(device=dev).manual_seed(seed + 109)
    hi, lo = hashing.split_ids_t(torch.from_numpy(batch["ids"]).to(dev).reshape(-1))
    n = hi.shape[0]
    uniq = dedup.unique_pairs(hi, lo, n)
    tr.train_step(batch)
    pr = table_ops.probe(spec, shard, uniq.hi, uniq.lo, uniq.valid)
    ok, C, W = pr.found, spec.capacity, spec.dim
    T, U = int(ok.sum()), uniq.hi.shape[0]
    shifts = [((pr.slot.long() + k * 7919 * LANES) % C) for k in range(8)]
    vrows = [torch.where(ok, s, -1).to(torch.int32) for s in shifts]
    vrow64 = [s[ok] for s in shifts]
    vals = shard.values
    out = [("row_gather", gather_entry("column block: values rows per step (128 lanes)", vals,
                                       [v.clamp(min=0) for v in vrows]))]
    zero = torch.zeros((U, W), device=dev)

    def merge_check():
        got, want = vals.clone(), vals.clone()
        for i in vrows[:2]:
            upd = torch.randn((U, W), device=dev, generator=g) * 1e-3
            row_merge_add(got, i, upd)
            row_merge_add_plain(want, i, upd)
        return max_abs_err("row_merge_add", got, want)

    out.append(("row_merge_add", entry(
        "column block: values update per step (unique rows, 128 lanes)",
        f"{tuple(vals.shape)} {vals.dtype}, m={U} ({T} valid rows)",
        4 * U + 4 * W * T + 2 * T * W * vals.element_size(),
        [lambda v=v: row_merge_add(vals, v, zero) for v in vrows],
        [lambda v=v: row_merge_add_plain(vals, v, zero) for v in vrows],
        [lambda v=v: vals.index_add_(0, v, zero[:T]) for v in vrow64],
        merge_check, "add_unique")))
    inv, order, sids = uniq.inverse, uniq.order, uniq.sorted_ids
    grads = [torch.randn((n, W), device=dev, generator=g) * 1e-3 for _ in range(8)]
    runs = int(torch.unique(inv).shape[0])

    def seg_check():
        got = dedup.segment_sum_grads(grads[0], inv, U, order, sids)
        want = row_merge_add_plain(torch.zeros((U, W), device=dev), inv, grads[0])
        return within_order_bound(got, want, order_bound(torch.zeros_like(got), inv, grads[0]))

    out.append(("row_merge_add", entry(
        f"column block: gradient segment sum per step (128 lanes, S={segment_size()})",
        f"[{n}, {W}] f32 -> [{U}, {W}] f32 ({runs} distinct rows)",
        4 * n + 4 * W * n + 4 * W * runs,
        [lambda x=x: dedup.segment_sum_grads(x, inv, U, order, sids) for x in grads],
        [lambda x=x: row_merge_add_plain(torch.zeros((U, W), device=dev), inv, x)
         for x in grads],
        [lambda x=x: torch.zeros((U, W), device=dev).index_add_(0, inv.long(), x)
         for x in grads],
        seg_check, "segment_")))
    log_timings(out)
    del tr, vals, shard
    torch.cuda.empty_cache()
    return out


# --- the sharded table groups (a world of one) -----------------------------------------

GROUP_SHARDED_CAP = 1 << 20  # part c's members
GROUP_SHARDED_REQUESTS = 32


def group_sharded_launches(cfgs: dict, ragged: bool) -> dict:
    """A ShardedGroupTrainer step at S = 1 with FORCE_EXCHANGE: each member's
    `member_launches`, plus the owner side's gather of its rows by its dedup
    inverse and the segment sum of the received gradients (2 K1), and, for
    the dense exchange, the gather of the returning rows."""
    total = group_launches(cfgs)
    for _ in cfgs:
        total["row_merge_add"] += 2
        total["row_gather"] += 1 if ragged else 2
    return total


def group_sharded_phase(args, group_p50: float, dev, card: str) -> dict:
    """The group_sharded phase (module docstring) on a world of one with
    FORCE_EXCHANGE on; the process group is destroyed at its end."""
    rehearse = dev.type == "cpu"
    bsz = args.batch if rehearse else TRAIN_BATCH
    nsteps = 3 if rehearse else 5 + TRAIN_STEPS
    mc = ModelConfig(kind="ctr_mlp")
    mesh = make_mesh(device=dev)
    meshes = {"cpu": make_mesh(device="cpu"), "card": mesh}
    out = {}
    try:
        st.FORCE_EXCHANGE = True
        # (a) 3 steps on the card and on the CPU from one state
        pcaps = {"user": 1 << 16, "item": 1 << 16, "ctx": 1 << 17}
        pb = list(SyntheticStream(SyntheticConfig(batch_size=512, seed=args.seed + 111))
                  .batches(3))
        for ragged in (False, True):
            name = "ragged" if ragged else "dense"
            runs = {}
            for k, m in meshes.items():
                tr = ShardedGroupTrainer(RunConfig(batch_size=512, steps=3, seed=args.seed,
                                                   a2a_ragged=ragged, pipeline_depth=0),
                                         group_cfgs(pcaps), GROUP_FEATURES, mc, mesh=m,
                                         generator=torch.Generator().manual_seed(args.seed + 113))
                runs[k] = (tr, [tr.train_step(b)["loss"] for b in pb])
            (ctr, closs), (gtr, gloss) = runs["cpu"], runs["card"]
            errs = {n: planes_agree(f"group_sharded parity {name} {n}", gtr.shards[n],
                                    ctr.shards[n]) for n in ctr.names}
            if gtr.counters() != ctr.counters():
                raise AssertionError(f"group_sharded parity {name}: counters differ")
            np.testing.assert_allclose(gloss, closs, rtol=1e-5, atol=1e-6)
            log(f"check group_sharded parity ({name} exchange, FORCE_EXCHANGE): 3 steps of 512 x "
                f"26 ids over {ctr.names}, {dev} vs CPU: planes and counters equal; max |{dev} - "
                f"CPU| {errs}; losses {gloss}")
            del runs, ctr, gtr

        # (b) steps of 4096 examples at config 2's widths, each exchange
        cfgs = group_cfgs({"user": 1 << 12, "item": 1 << 12, "ctx": 1 << 13} if rehearse
                          else GROUP_CAPS)
        batches = list(SyntheticStream(SyntheticConfig(batch_size=bsz, seed=args.seed + 115))
                       .batches(nsteps))
        for ragged in (False, True):
            name = "ragged" if ragged else "dense"
            tr = ShardedGroupTrainer(RunConfig(batch_size=bsz, steps=nsteps, seed=args.seed,
                                               a2a_ragged=ragged, pipeline_depth=0), cfgs,
                                     GROUP_FEATURES, mc,
                                     mesh=mesh,
                                     generator=torch.Generator().manual_seed(args.seed + 117))
            c0 = {n: dict(c) for n, c in tr.counters().items()}
            out[name] = run_steps(f"group_sharded {name}", lambda b: tr.train_step(b)["loss"],
                                  batches, dev, card, group_sharded_launches(cfgs, ragged))
            c1 = tr.counters()
            for n in tr.names:
                check_drops(f"group_sharded {name} {n}", c0[n], c1[n])
            if tr.a2a_factor != tr.run_cfg.a2a_factor:  # resized after route drops
                raise AssertionError(f"group_sharded {name}: route drops")
            del tr
            gc.collect()
        log(f"group_sharded: step p50 dense {out['dense']['p50_ms']:.3f} ms, ragged "
            f"{out['ragged']['p50_ms']:.3f} ms, GroupTrainer's {group_p50:.3f} ms (the group "
            f"phase) on {card}")

        # (c) reduced depth: a sharded checkpoint -> GroupTrainer and the services
        cap = 1 << 13 if rehearse else GROUP_SHARDED_CAP
        cfgs = group_cfgs({"user": cap, "item": cap, "ctx": cap})
        run_cfg = RunConfig(batch_size=bsz, steps=5, seed=args.seed, pipeline_depth=0)
        tr = ShardedGroupTrainer(run_cfg, cfgs, GROUP_FEATURES, mc, mesh=mesh,
                                 generator=torch.Generator().manual_seed(args.seed + 119))
        more = list(SyntheticStream(SyntheticConfig(batch_size=bsz, seed=args.seed + 121))
                    .batches(5 + GROUP_SHARDED_REQUESTS))
        for b in more[:5]:
            tr.train_step(b)
        root = ROOT / "build" / "chip_smoke" / "group_sharded"
        shutil.rmtree(root, ignore_errors=True)
        try:
            tr.save_checkpoint(str(root))
            single = GroupTrainer(run_cfg, cfgs, GROUP_FEATURES, mc, device=dev)
            single.load_checkpoint(str(root))
            for n in tr.names:
                a = export_shard_arrays(tr.specs[n], tr.shards[n])
                b = export_shard_arrays(single.specs[n], single.shards[n])
                oa, ob = np.argsort(a["ids"]), np.argsort(b["ids"])
                for k in a:
                    if not np.array_equal(a[k][oa], b[k][ob]):
                        raise AssertionError(f"group_sharded restore: {n} {k} differs")
            svc = GroupScoringService(str(root), run_cfg, cfgs, GROUP_FEATURES, mc,
                                      distributed=True, mesh=mesh, device=dev)
            ref = GroupScoringService(str(root), run_cfg, cfgs, GROUP_FEATURES, mc, device=dev)
            lat = {"distributed": [], "single": []}
            for b in more[5:]:
                scores = {}
                for k, s in (("distributed", svc), ("single", ref)):
                    t0 = time.perf_counter()
                    scores[k] = s.score(b["dense"], b["ids"])
                    lat[k].append((time.perf_counter() - t0) * 1e3)
                np.testing.assert_allclose(scores["distributed"], scores["single"], rtol=1e-6,
                                           atol=0)
            if svc.route_drops:
                raise AssertionError(f"group_sharded service: {svc.route_drops} route drops")
            # the sharded_http phase's group request and its single-device scores
            b = more[5]
            HTTP_DIR.mkdir(parents=True, exist_ok=True)
            np.savez(HTTP_DIR / "group_ref.npz", dense=b["dense"], ids=b["ids"],
                     scores=ref.score(b["dense"], b["ids"]))
            del svc, ref
            shutil.move(str(root), str(HTTP_DIR / "group_ckpt"))
            out["request_p50_ms"] = float(np.percentile(lat["distributed"][1:], 50))
            out["single_request_p50_ms"] = float(np.percentile(lat["single"][1:], 50))
            rows = sum(c["rows"] for c in tr.counters().values())
            log(f"group_sharded: a sharded group checkpoint ({rows} rows) restores into a GroupTrainer with every row equal; "
                f"GroupScoringService(distributed=True) scores {len(lat['single'])} requests of "
                f"{bsz} examples as the single-device service (rtol 1e-6): request p50 "
                f"{out['request_p50_ms']:.3f} ms vs {out['single_request_p50_ms']:.3f} ms on "
                f"{card}")
        finally:
            shutil.rmtree(root.parent, ignore_errors=True)
    finally:
        st.FORCE_EXCHANGE = False
        pmesh.destroy()
    return out


# --- one HTTP front over S ranks ------------------------------------------------------

FRONT_S = 2  # rank processes of the sharded_http phase, on the one card
FRONT_PARTS = ("score", "retrieve", "group")
FRONT_CAP = 1 << 27  # config 2's capacity: 2^26 slots a rank (~9.3 GiB)


def front_service(part: str, args, mesh, dev):
    """This rank's service of a sharded_http part, on the checkpoint an
    earlier phase left in HTTP_DIR."""
    rehearse = dev.type == "cpu"
    if part == "score":
        cfg = TableConfig(dim=32, capacity=args.capacity if rehearse else FRONT_CAP)
        return ShardedScoringService(str(HTTP_DIR / "serve_ckpt"), cfg, ModelConfig(), mesh=mesh)
    if part == "retrieve":
        cfg = TableConfig(dim=32, capacity=args.capacity if rehearse else RETR_CAP)
        return ShardedScoringService(str(HTTP_DIR / "retrieval_ckpt"), cfg,
                                     zoo_model_cfg("two_tower"), mesh=mesh)
    cap = 1 << 13 if rehearse else GROUP_SHARDED_CAP
    run_cfg = RunConfig(batch_size=args.batch if rehearse else TRAIN_BATCH, steps=5,
                        seed=args.seed, pipeline_depth=0)
    return GroupScoringService(str(HTTP_DIR / "group_ckpt"), run_cfg,
                               group_cfgs({"user": cap, "item": cap, "ctx": cap}),
                               GROUP_FEATURES, ModelConfig(kind="ctr_mlp"), distributed=True,
                               mesh=mesh, device=dev)


def _count_calls(svc, name: str, record: list) -> None:
    """Wrap svc.<name> so that each call appends its kernel launches."""
    fn = getattr(svc, name)

    def call(*a, **k):
        at = launches()
        out = fn(*a, **k)
        record.append(_launch_delta(at))
        return out

    setattr(svc, name, call)


def front_rank_main(args) -> int:
    """One rank of the sharded_http phase (`--front-rank`): for each part, a
    per-rank service behind a `LockstepFront`; rank 0 serves HTTP on a free
    port, which it writes to the meeting directory, until a line on its
    standard input stops the front. The counters are set to 0 just before
    the first part; each score and lookup call records its launches. Prints
    its results as the last JSON line."""
    rehearse = args.rehearse_on_cpu
    if rehearse:
        cap_cpu_threads()
    dev = torch.device("cpu" if rehearse else "cuda")
    root = Path(args.front_dir)
    rank = args.front_rank
    pmesh.init_distributed("gloo", f"file://{root / 'store'}", rank, FRONT_S, device=dev)
    try:
        mesh = make_mesh(device=dev)
        out = {"rank": rank, "calls": {}, "rc": {}}
        reset_launches()
        for part in FRONT_PARTS:
            t0 = time.perf_counter()
            svc = front_service(part, args, mesh, dev)
            calls = out["calls"][part] = []
            for name in ("score", "lookup"):
                if hasattr(svc, name):
                    _count_calls(svc, name, calls)
            front = LockstepFront(svc, mesh)
            if rank:
                out["rc"][part] = front.follow()
            else:
                ret = None
                if part == "retrieve":
                    ret = RetrievalService(front)
                    ret.build_index(np.load(HTTP_DIR / "retrieval_ref.npz")["items"])
                server = make_http_server(front, 0, retrieval=ret)
                log(f"sharded_http rank 0: {part} up in {time.perf_counter() - t0:.1f} s")
                (root / f"port-{part}.tmp").write_text(str(server.server_address[1]))
                (root / f"port-{part}.tmp").rename(root / f"port-{part}")
                def stop_on_a_line(front=front):
                    sys.stdin.readline()
                    front.stop()

                stopper = threading.Thread(target=stop_on_a_line, daemon=True)
                stopper.start()
                out["rc"][part] = front.run(server)
                stopper.join(timeout=60)
                del ret, server
            del front, svc
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        out["launches"] = launches()
        print(json.dumps(out), flush=True)
    finally:
        pmesh.destroy()
    return 0


def _wait_port(path: Path, procs) -> int:
    deadline = time.monotonic() + 900
    while not path.exists():
        if any(p.poll() is not None for p in procs) or time.monotonic() > deadline:
            raise AssertionError(f"sharded_http: the ranks never served ({path.name})")
        time.sleep(0.05)
    return int(path.read_text())


def _same_scores(what: str, rep: dict, want) -> None:
    np.testing.assert_allclose(rep["scores"], want, rtol=1e-5, atol=1e-6, err_msg=what)


def front_score_part(args, port: int) -> dict:
    """The serve phase's requests through the front, against its
    single-device scores; /healthz, /metrics, a malformed body, a reload of
    the same checkpoint and of a missing one. Returns the timed requests'
    p50/p99 and the /score requests the ranks scored."""
    z = np.load(HTTP_DIR / "serve_ref.npz")
    n = len([k for k in z.files if k.startswith("scores")])
    code, health = http_call(port, "/healthz")
    if code != 200 or health["rows"] != args.ckpt_rows or health["devices"] != FRONT_S:
        raise AssertionError(f"sharded_http /healthz: {code} {health}")
    lat = []
    for j in range(n):
        body = score_body(z[f"dense{j}"], z[f"ids{j}"])
        t0 = time.perf_counter()
        code, rep = http_call(port, "/score", body)
        ms = (time.perf_counter() - t0) * 1e3
        if code != 200:
            raise AssertionError(f"sharded_http POST /score: {code} {rep}")
        _same_scores(f"sharded_http request {j} ({len(z[f'dense{j}'])} rows)", rep,
                     z[f"scores{j}"])
        if HTTP_WARM <= j < n - 1:
            lat.append(ms)
    code, text = http_call(port, "/metrics")
    if f"meepo_mesh_devices {FRONT_S}" not in text or "meepo_route_drops_total 0" not in text:
        raise AssertionError(f"sharded_http /metrics:\n{text}")
    # rank 0's own part of a request: its service's scoring latency
    own_p50 = float(next(line.split()[-1] for line in text.splitlines()
                         if line.startswith('meepo_score_latency_ms{quantile="0.5"}')))
    first = score_body(z["dense0"], z["ids0"])
    code, rep = http_call(port, "/score", b'{"dense": [[1.0]], "ids": [[1, 2]]}')
    if code != 400:
        raise AssertionError(f"sharded_http: a malformed body answered {code} {rep}")
    code, before = http_call(port, "/score", first)
    _same_scores("sharded_http: after a malformed body", before, z["scores0"])
    ckpt = str(HTTP_DIR / "serve_ckpt")
    code, rep = http_call(port, "/reload", json.dumps({"ckpt": ckpt}).encode())
    if code != 200 or rep["rows"] != args.ckpt_rows:
        raise AssertionError(f"sharded_http: /reload of the checkpoint: {code} {rep}")
    code, rep = http_call(port, "/reload", json.dumps({"ckpt": ckpt + "-missing"}).encode())
    if code != 400:
        raise AssertionError(f"sharded_http: /reload of a missing path answered {code} {rep}")
    code, after = http_call(port, "/score", first)
    if code != 200 or after["scores"] != before["scores"]:
        raise AssertionError("sharded_http: the scores changed after a refused reload")
    code, health = http_call(port, "/healthz")
    if health["rows"] != args.ckpt_rows:
        raise AssertionError(f"sharded_http: {health['rows']} rows after the reloads")
    lat = np.asarray(lat)
    # the ranks scored every request, twice more the first, not the malformed one
    return {"p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "scored": n + 2, "timed": len(lat), "own_p50_ms": own_p50}


def front_retrieve_part(args, port: int) -> dict:
    """POST /retrieve through the front against a single-device
    RetrievalService's keys and scores on the same cut corpus."""
    z = np.load(HTTP_DIR / "retrieval_ref.npz")
    body = json.dumps({"dense": z["dense"].tolist(), "ids": z["ids"].tolist(),
                       "k": RETR_K}).encode()
    code, rep = http_call(port, "/retrieve", body)
    if code != 200 or not np.array_equal(np.asarray(rep["keys"]), z["keys"]):
        raise AssertionError(f"sharded_http /retrieve: {code}, keys differ from the "
                             f"single-device RetrievalService's")
    np.testing.assert_allclose(rep["scores"], z["scores"], rtol=1e-5, atol=1e-6)
    items = len(z["items"])
    embed_batch = inspect.signature(RetrievalService).parameters["embed_batch"].default
    # the index build's lookups, then the request's
    return {"items": items, "lookups": -(-items // embed_batch) + 1}


def front_group_part(args, port: int) -> dict:
    """One group request through the front against the single-device
    GroupScoringService's scores."""
    z = np.load(HTTP_DIR / "group_ref.npz")
    code, rep = http_call(port, "/score", score_body(z["dense"], z["ids"]))
    if code != 200:
        raise AssertionError(f"sharded_http group POST /score: {code} {rep}")
    _same_scores("sharded_http group request", rep, z["scores"])
    code, health = http_call(port, "/healthz")
    if code != 200 or health["devices"] != FRONT_S or health["route_drops"]:
        raise AssertionError(f"sharded_http group /healthz: {code} {health}")
    return {"scored": 1, "rows": health["rows"]}


def sharded_http_phase(args, single: dict, dev, card: str) -> dict:
    """The sharded_http phase (module docstring): FRONT_S rank processes of
    this script on one card in a gloo group; this process is the HTTP
    client. Returns the launches summed over the ranks."""
    rehearse = dev.type == "cpu"
    root = HTTP_DIR / "front"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--seed", str(args.seed),
           "--batch", str(args.batch), "--capacity", str(args.capacity),
           "--front-dir", str(root)] + (["--rehearse-on-cpu"] if rehearse else [])
    logs = [open(root / f"rank{r}.log", "w") for r in range(FRONT_S)]
    procs = [subprocess.Popen(cmd + ["--front-rank", str(r)], stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=str(ROOT), text=True,
                              stdin=subprocess.PIPE if r == 0 else subprocess.DEVNULL)
             for r in range(FRONT_S)]
    t0 = time.perf_counter()
    parts = {"score": front_score_part, "retrieve": front_retrieve_part,
             "group": front_group_part}
    res = {}
    try:
        for part in FRONT_PARTS:
            res[part] = parts[part](args, _wait_port(root / f"port-{part}", procs))
            procs[0].stdin.write("stop\n")
            procs[0].stdin.flush()
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    phase_s = time.perf_counter() - t0
    ranks = []
    for r, p in enumerate(procs):
        lines = (root / f"rank{r}.log").read_text().splitlines()
        for line in lines:
            if not line.startswith("{"):
                log(f"sharded_http rank {r} | {line}")
        if p.returncode != 0:
            raise AssertionError(f"sharded_http rank {r} exited {p.returncode}")
        ranks.append(json.loads([x for x in lines if x.startswith("{")][-1]))
    # each rank's launches a call: a request's or an index lookup's
    # SHARDED_REQUEST_GATHERS and SHARDED_REQUEST_PROBES, a group request's
    # that many a member
    one = (SHARDED_REQUEST_GATHERS, SHARDED_REQUEST_PROBES)
    want = {"score": [one] * res["score"]["scored"],
            "retrieve": [one] * res["retrieve"]["lookups"],
            "group": [tuple(len(GROUP_CAPS) * x for x in one)] * res["group"]["scored"]}
    for rk in ranks:
        if rk["rc"] != {p: 0 for p in FRONT_PARTS}:
            raise AssertionError(f"sharded_http rank {rk['rank']}: the stop op returned "
                                 f"{rk['rc']}")
        for part in FRONT_PARTS:
            calls = rk["calls"][part]
            if len(calls) != len(want[part]):
                raise AssertionError(f"sharded_http rank {rk['rank']} {part}: {len(calls)} calls, "
                                     f"not {len(want[part])}")
            for c, (g, p) in zip(calls, want[part]):
                if dev.type == "cuda" and c != {**{k: 0 for k in c}, "row_gather": g,
                                                "bucket_probe": p}:
                    raise AssertionError(f"sharded_http rank {rk['rank']} {part}: a call "
                                         f"launched {c}, not {g} row_gather, {p} bucket_probe "
                                         f"and nothing else")
    total = {k: sum(rk["launches"][k] for rk in ranks) for k in ranks[0]["launches"]}
    sc = res["score"]
    log(f"sharded_http: one LockstepFront over {FRONT_S} rank processes on {card} (a gloo "
        f"group: on one card gloo stages every collective through the host, so this prices "
        f"the front, not a wire); {sc['timed']} POST /score of {args.batch} x 26 ids: p50 "
        f"{sc['p50_ms']:.3f} ms, p99 {sc['p99_ms']:.3f} ms, against the single-device HTTP "
        f"p50 {single['p50_ms']:.3f} ms, p99 {single['p99_ms']:.3f} ms on {card} (rank 0's "
        f"own scoring of its rows, /metrics: p50 {sc['own_p50_ms']:.3f} ms); every reply "
        f"(and one of 37 rows) equals the single-device scores (rtol 1e-5, atol 1e-6); a "
        f"malformed body 400 and the next request answered; /reload kept the rows, a missing "
        f"path 400 with the scores unchanged; /retrieve over {res['retrieve']['items']} items "
        f"equals the single-device keys; a group request equals the single-device "
        f"GroupScoringService's; the stop op ended both ranks with 0; "
        f"{SHARDED_REQUEST_GATHERS} row_gather and {SHARDED_REQUEST_PROBES} bucket_probe a "
        f"request a rank; phase {phase_s:.1f} s; "
        f"launches {total}")
    return {"launches": total, "score": sc, "seconds": phase_s}


def entry_phase(args, dev, card: str) -> dict:
    """The entry phase (module docstring). Returns the forward's launches."""
    from meepoembedding_tpu_torch import entry as entry_mod

    run, table_cfg, model_cfg = entry_mod._cfgs()
    spec = TableSpec.from_config(table_cfg, num_shards=1)
    ids = np.unique(entry_mod._batch(run, model_cfg)["ids"])
    rows = np.random.default_rng(args.seed + 141).standard_normal(
        (len(ids), spec.dim)).astype(np.float32) * 0.1
    outs = {}
    for where in (dev, torch.device("cpu")):
        fwd, (shard, model, dense, hi, lo) = entry_mod.entry(device=where)
        h, lo_ = hashing.split_ids_t(torch.from_numpy(ids).to(where))
        table_ops.insert_rows(spec, shard, h, lo_, torch.from_numpy(rows).to(where),
                              hashing.is_valid(h, lo_), 0)
        sync(where)
        at = launches()
        with torch.no_grad():
            outs[where.type] = fwd(shard, model, dense, hi, lo).cpu().numpy()
        sync(where)
        if where == dev:
            counts = _launch_delta(at)
    np.testing.assert_allclose(outs[dev.type], outs["cpu"], rtol=1e-5, atol=1e-6)
    if dev.type == "cuda" and counts != {**{k: 0 for k in counts}, "row_gather": 2,
                                         "bucket_probe": 1}:
        raise AssertionError(f"entry's forward launched {counts}, not 2 row_gather (the "
                             f"values, the inverse), 1 bucket_probe and nothing else")
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    t0 = time.perf_counter()
    entry_mod.dryrun_multichip(n, device=dev)
    log(f"entry: forward of {run.batch_size} x {model_cfg.num_sparse_features} ids over "
        f"{len(ids)} rows on {dev} equals the CPU's through the plain versions (rtol 1e-5, "
        f"atol 1e-6), launches {counts}; dryrun_multichip({n}) passed in "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    return counts


# --- the measurement harnesses -------------------------------------------------

HARNESS_DIR = ROOT / "build" / "chip_smoke_harness"  # ckpt_full's checkpoint, removed after
HARNESS_STEPS = 20  # the headline's timed steps a window (the part to cut first)
HARNESS_KEYS = {  # the reference scripts' JSON keys, in their order
    "headline": ["metric", "value", "unit", "vs_baseline", "vs_sol_unique"],
    "evict": ["metric", "capacity", "dim", "dtype", "live_rows", "scan_only_ms",
              "with_exports_ms", "windowed_ms", "window_buckets", "max_evict_per_pass",
              "evicted_rich"],
    "ckpt_full": ["metric", "capacity", "dtype", "rows", "save_s", "gib", "mib_per_s",
                  "restore_s", "sample_bit_exact"],
    "serving": ["mode", "scores_per_sec", "p50_ms", "p99_ms", "table_mb"],
    "index_build": ["phase", "items_per_sec", "items"],
    "topk": ["phase", "queries_per_sec", "p50_ms", "p99_ms", "corpus", "k", "dim",
             "index_dtype"],
    "sharded_overhead": ["metric", "devices", "ids_per_step", "fused_ms", "sharded_ms",
                         "overhead", "route_drops", "exchange_forced_ms", "exchange_overhead",
                         "exchange_ragged_ms", "exchange_ragged_overhead", "group_ms",
                         "group_sharded_ms", "group_overhead"],
    "scaling": ["metric", "platform", "per_device_batch", "rates", "efficiency"],
}


def _held_rows(name: str, planes, idx):
    """(the distinct rows of `idx` in range, idx mapped onto them (-1 out of
    range), each plane's copy of those rows) for an in-place kernel's
    check; raises on a repeated row, which the kernels' contract forbids
    (on the card repeated rows race)."""
    i = idx.long()
    ok = (i >= 0) & (i < planes[0].shape[0])
    rows = torch.unique(i[ok])
    if rows.numel() != int(ok.sum()):
        raise AssertionError(f"{name} given {int(ok.sum()) - rows.numel()} repeated rows")
    local = torch.where(ok, torch.searchsorted(rows, i), -1).to(torch.int32)
    return rows, local, [p[rows].clone() for p in planes]


class _Held:
    """A held wrapper of `kernel`: calls `fn`, reads the kernel's name and
    launch count through."""

    def __init__(self, kernel, fn):
        self.kernel, self.fn, self.__name__ = kernel, fn, kernel.__name__

    @property
    def launches(self):
        return self.kernel.launches

    def __call__(self, *a, **k):
        return self.fn(*a, **k)


@contextlib.contextmanager
def held_kernels(held: list):
    """While inside, every kernel wrapper that a module of the port holds
    (the kernels' own modules aside) is replaced by one that makes
    the same call and, on the first call at each set of planes (shapes and
    types) and power-of-two size class of n, holds it against the plain
    version on the same inputs: gathers and sets bit-exact; the in-place
    adds and sets on a copy of the rows they touch, bit-exact (rows unique,
    as their contract asks, else it raises); the segment sum within the
    summation-order bound; the block copies K6 / K7 once at each (R, W)
    too, the gather bit-exact, the scatter bit-exact where its blocks are
    disjoint and, on a row that blocks share, equal to one of its writers'
    rows (the kernel's contract); the bucket probe at each set of rounds,
    slot and found bit-exact. Appends (kernel, planes, n, max |kernel -
    plain|) to `held` for each held call. Launches are the wrapped calls'
    own."""
    seen = set()

    def first(name, planes, n, extra=()) -> bool:
        key = (name, tuple((tuple(p.shape), p.dtype) for p in planes), max(n, 1).bit_length(),
               extra)
        if key in seen:
            return False
        seen.add(key)
        return True

    def note(name, planes, n, err) -> None:
        shapes = " + ".join(f"{tuple(p.shape)} {str(p.dtype).replace('torch.', '')}"
                            for p in planes)
        held.append((name, shapes, n, err))

    def gather_multi(planes, idx):
        out = row_gather_multi(planes, idx)
        if first("row_gather", planes, idx.shape[0]):
            note("row_gather", planes, idx.shape[0], max(
                max_abs_err("row_gather", a, b)
                for a, b in zip(out, row_gather_multi_plain(planes, idx))))
        return out

    def set_multi(planes, idx, values):
        if not first("row_scatter_set", planes, idx.shape[0]):
            return row_scatter_set_multi(planes, idx, values)
        rows, local, copies = _held_rows("row_scatter_set", planes, idx)
        row_scatter_set_multi(planes, idx, values)
        row_scatter_set_multi_plain(copies, local, values)
        note("row_scatter_set", planes, idx.shape[0], max(
            max_abs_err("row_scatter_set", p[rows], c) for p, c in zip(planes, copies)))

    def scatter_add(plane, idx, upd, old=None):
        if not first("row_scatter_add", [plane], idx.shape[0]):
            return row_scatter_add(plane, idx, upd, old)
        rows, local, (copy,) = _held_rows("row_scatter_add", [plane], idx)
        row_scatter_add(plane, idx, upd, old)
        old_plain = None if old is None else torch.empty_like(old)
        row_scatter_add_plain(copy, local, upd, old_plain)
        err = max_abs_err("row_scatter_add", plane[rows], copy)
        if old is not None:
            err = max(err, max_abs_err("row_scatter_add old", old, old_plain))
        note("row_scatter_add", [plane], idx.shape[0], err)
        return plane

    def merge_add(plane, vrow, upd):
        if not first("row_merge_add", [plane], vrow.shape[0]):
            return row_merge_add(plane, vrow, upd)
        rows, local, (copy,) = _held_rows("row_merge_add", [plane], vrow)
        row_merge_add(plane, vrow, upd)
        row_merge_add_plain(copy, local, upd)
        note("row_merge_add", [plane], vrow.shape[0],
             max_abs_err("row_merge_add", plane[rows], copy))
        return plane

    def seg_sum(upd, vrow, num_rows, order=None, sorted_rows=None):
        out = segment_sum(upd, vrow, num_rows, order, sorted_rows)
        if first("segment_sum", [upd], vrow.shape[0]):
            zero = torch.zeros_like(out)
            want = row_merge_add_plain(zero.clone(), vrow, upd)
            note("segment_sum", [upd], vrow.shape[0],
                 within_order_bound(out, want, order_bound(zero, vrow, upd)))
        return out

    def block_gather(plane, base, R, W):
        out = row_block_gather(plane, base, R, W)
        if first("row_block_gather", [plane], base.shape[0], (R, W)):
            note(f"row_block_gather R={R} W={W}", [plane], base.shape[0], max_abs_err(
                "row_block_gather", out, row_block_gather_plain(plane, base, R)))
        return out

    def block_scatter(plane, base, upd, R, W):
        if not first("row_block_scatter", [plane], base.shape[0], (R, W)):
            return row_block_scatter(plane, base, upd, R, W)
        rows = block_rows(base, R, plane.shape[0])
        row_block_scatter(plane, base, upd, R, W)
        uniq, inv = torch.unique(rows, return_inverse=True)
        shared = rows.numel() - uniq.numel()
        if not shared:  # the plain version's rows: upd's, in order
            err = max_abs_err("row_block_scatter", plane[rows], upd)
        else:
            hit = (_bits(plane[rows]) == _bits(upd)).all(1).to(torch.int32)
            won = torch.zeros_like(uniq, dtype=torch.int32).scatter_reduce_(0, inv, hit, "amax")
            if not bool(won.all()):
                raise AssertionError(f"row_block_scatter R={R} W={W}: {int((won == 0).sum())} "
                                     f"rows hold none of their writers' rows")
            err = 0.0
        note(f"row_block_scatter R={R} W={W}" + (f" ({shared} writes to rows blocks share)"
                                                  if shared else ""),
             [plane], base.shape[0], err)
        return plane

    def probe(key_hi, key_lo, uh, ul, valid, rounds):
        out = bucket_probe(key_hi, key_lo, uh, ul, valid, rounds)
        if first("bucket_probe", [key_hi], uh.shape[0], (rounds,)):
            # the plain version gathers through row_gather_multi: launches
            # of the check, not of the harness
            gathers = row_gather.launches
            want = bucket_probe_plain(key_hi, key_lo, uh, ul, valid, rounds)
            row_gather.launches = gathers
            note("bucket_probe", [key_hi, key_lo], uh.shape[0], max(
                max_abs_err("bucket_probe slot", out[0], want[0]),
                max_abs_err("bucket_probe found", out[1].int(), want[1].int())))
        return out

    wrap = {"row_gather": lambda plane, idx: gather_multi((plane,), idx)[0],
            "row_gather_multi": gather_multi,
            "row_scatter_set": lambda plane, idx, upd: set_multi((plane,), idx, (upd,)) or plane,
            "row_scatter_set_multi": set_multi, "row_scatter_add": scatter_add,
            "row_merge_add": merge_add, "segment_sum": seg_sum,
            "row_block_gather": block_gather, "row_block_scatter": block_scatter,
            "bucket_probe": probe}
    orig = {k.__name__: k for k in (row_gather, row_gather_multi, row_scatter_set,
                                    row_scatter_set_multi, row_scatter_add, row_merge_add,
                                    segment_sum, row_block_gather, row_block_scatter,
                                    bucket_probe)}
    patched = []
    for modname, mod in list(sys.modules.items()):
        if modname.startswith("meepoembedding_tpu_torch") and \
                not modname.startswith("meepoembedding_tpu_torch.kernels"):
            for name in orig:
                if getattr(mod, name, None) is orig[name]:
                    setattr(mod, name, _Held(orig[name], wrap[name]))
                    patched.append((mod, name))
    try:
        yield
    finally:
        for mod, name in patched:
            setattr(mod, name, orig[name])


def held_summary(held: list) -> str:
    """The held calls, one `kernel planes n=..` a call, and the largest error."""
    calls = "; ".join(f"{k} {shapes} n={n}" for k, shapes, n, _ in held)
    return (f"{len(held)} calls held against the plain versions on the same inputs, "
            f"max |kernel - plain| {max((e for *_, e in held), default=0.0)}: {calls}")


def harness_sizes(args, rehearse: bool) -> dict:
    """Each harness's knobs: the module docstring's sizes on the card, tiny
    ones in a rehearsal."""
    arms = "fast,exchange,ragged,group"
    if rehearse:
        cap = args.capacity
        return {
            "headline": dict(cap=cap, batch=1024, steps=2),
            "phases": dict(cap=cap, batch=1024, steps=2, windows=1),
            "stages": dict(cap=cap, batch=1024),
            "evict": dict(cap=cap, reps=2, window=16),
            "ckpt_full": dict(cap=cap, ckpt_dir=str(HARNESS_DIR / "ckpt"), sample=500),
            "serving": dict(rows=2048, batch=64, steps=3),
            "retrieval": dict(items=4096, batch=32, steps=2),
            "sharded_overhead": dict(cap=4 * cap, batch=64, feats=8, steps=2, prefill=2,
                                     arms=arms),
            "scaling": dict(devices="1", batch=64, steps=2),
        }
    return {
        "headline": dict(cap=1 << 27, batch=1 << 19, steps=HARNESS_STEPS),
        "phases": {}, "stages": {}, "evict": {},
        "ckpt_full": dict(cap=1 << 25, ckpt_dir=str(HARNESS_DIR / "ckpt")),
        "serving": {}, "retrieval": {},
        "sharded_overhead": dict(arms=arms),
        "scaling": dict(devices="1", batch=1024, steps=10),  # the reference's defaults
    }


def headline_launches(cap: int, batch: int, steps: int, rounds: int) -> dict:
    """The headline's launches, from its steps: P prefill batches (a
    lookup_train of 1 probe, 1 gather and 1 set, the update's fetch-add and
    values add), 1 + 3 x steps dynamic cycles (the train phase's step
    without the tower: 1 probe, 2 gathers, 1 set, 1 fetch-add, 3 K1), as
    many cycles of the all-rows static arm (1 gather; the segment sum's 2 K1
    and the add) and of the dedup-aware arm (2 gathers, 3 K1), and 1 gather
    a planning round."""
    n_live = int(cap * 0.8)
    P = -(-n_live // min(batch, 1 << 20, n_live))
    C = 1 + 3 * steps
    return {"row_gather": P + 2 * C + C + 2 * C + rounds, "row_scatter_set": P + C,
            "row_scatter_add": P + C, "row_merge_add": P + 3 * C + 3 * C + 3 * C,
            "bucket_probe": P + C}


def check_static_arms(seed: int) -> None:
    """The static arms the headline and phases harnesses time, one cycle
    each on the card, on a [2^27, 32] f32 plane from --seed at the
    headline's batch (2^19 slots drawn with repeats from 107.4M rows; the
    dedup-aware arm on one batch of its Zipf stream), against the same
    cycle through the plain versions on the CPU, on the rows it touches:
    within the summation-order bound, where a race on a repeated row (an
    update lost) would show."""
    from meepoembedding_tpu_torch.bench import _common, headline, phases

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 211)
    R, batch, gseed = 1 << 27, 1 << 19, 1e-4
    n_live = int(R * 0.8)
    values = torch.randn((R, 32), device=dev, generator=g)
    slot = torch.randint(0, n_live, (batch,), device=dev, generator=g, dtype=torch.int32)
    keys = _common.IdStream(n_live, batch).keys()
    ucap = -(-int(len(np.unique(keys)) * 1.15) // 128) * 128
    su, inv, order, srt = headline.unique_batch(keys, ucap, dev)
    static = (slot, *headline.unique_batch(slot.cpu().numpy(), batch, dev))
    # (name, arm, its arguments on the card, which of them index the plane, the
    # row each draw updates)
    arms = (("static, segment_sum + row_merge_add", headline.static_cycle, static, (0, 1), slot),
            ("static, library index_add_", phases.static_library_cycle, (slot,), (0,), slot),
            ("dedup-aware static", headline.static_unique_cycle, (su, inv, order, srt), (0,),
             su[inv.long()]))
    for name, fn, card_args, plane_args, per_draw in arms:
        rows = torch.unique(per_draw).long()

        def local(ix):
            return torch.where(ix >= 0, torch.searchsorted(rows, ix.long()), -1).to(
                torch.int32).cpu()

        before = values[rows].cpu()
        want = before.clone()
        cpu_args = tuple(local(a) if k in plane_args else a.cpu()
                         for k, a in enumerate(card_args))
        fn(want, *cpu_args, gseed)
        fn(values, *card_args, gseed)
        torch.cuda.synchronize()
        vrow = local(per_draw)
        upd = -0.05 * (before[vrow.long()] * 1e-3 + gseed)
        err = within_order_bound(values[rows].cpu(), want, order_bound(before, vrow, upd))
        log(f"check harness {name}: one cycle of {batch} draws onto {rows.shape[0]} rows "
            f"of a [{R}, 32] f32 plane equals the plain versions' within the summation-order "
            f"bound (max |card - plain| {err})")
    del values
    torch.cuda.empty_cache()


def harness_phase(args, dev, card: str) -> dict:
    """The harness phase (module docstring). Returns the launches of its
    in-process runs plus scaling's rank 0."""
    from meepoembedding_tpu_torch.bench import (
        ckpt_full,
        evict,
        headline,
        phases,
        retrieval,
        scaling,
        serving,
        sharded_overhead,
        stages,
    )

    rehearse = dev.type == "cpu"
    sizes = harness_sizes(args, rehearse)
    total = {k: 0 for k in launches()}
    shutil.rmtree(HARNESS_DIR, ignore_errors=True)
    try:
        for name, mod in (("headline", headline), ("phases", phases), ("stages", stages),
                          ("evict", evict), ("ckpt_full", ckpt_full), ("serving", serving),
                          ("retrieval", retrieval), ("sharded_overhead", sharded_overhead),
                          ("scaling", scaling)):
            gc.collect()
            if not rehearse:
                torch.cuda.empty_cache()
            reset_launches()
            err, held = io.StringIO(), []
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stderr(err), held_kernels(held):
                    res = mod.run(device=dev, **sizes[name])
            finally:
                for line in err.getvalue().splitlines():
                    log(f"harness {name} | {line}")
            secs = time.perf_counter() - t0
            counts, rounds = launches(), plan_rounds()
            if name == "scaling":  # its ranks are processes of their own
                counts = json.loads(re.search(r"^S=1: rank 0 launches (.*)$", err.getvalue(),
                                              re.M).group(1))
                # rank 0 of S = 1 once more in this process, its calls held
                HARNESS_DIR.mkdir(parents=True, exist_ok=True)
                with held_kernels(held):
                    scaling.rank_main(0, 1, str(HARNESS_DIR), dev.type, sizes[name]["batch"],
                                      sizes[name]["steps"])
            log(f"harness {name}: {held_summary(held)}")
            if not held and name != "retrieval":
                raise AssertionError(f"harness {name}: no kernel call was held")
            for line in res.values() if name in ("serving", "retrieval") else (res,):
                key = {"serving": "serving", "retrieval": line.get("phase")}.get(name, name)
                if key in HARNESS_KEYS and list(line) != HARNESS_KEYS[key]:
                    raise AssertionError(f"harness {name}: keys {list(line)}, not the "
                                         f"reference's {HARNESS_KEYS[key]}")
                log(f"harness {name}: {json.dumps(line)}")
            if name == "phases" and [p["name"] for p in res["phases"]] != [
                    n for n, _ in phases.STEPS]:
                raise AssertionError(f"phases: steps {res['phases']}")
            if name == "stages" and len(res["stages"]) != len(stages.STAGES):
                raise AssertionError(f"stages: {res['stages']}")
            if name == "evict" and res["evicted_rich"] < 1:
                raise AssertionError("evict: the candidate-rich passes exported no row")
            if name == "ckpt_full" and res.get("sample_bit_exact") is not True:
                raise AssertionError(f"ckpt_full: {res}")
            if name == "sharded_overhead" and res["route_drops"] != 0:
                raise AssertionError(f"sharded_overhead: {res['route_drops']} route drops")
            if name == "headline":
                drop = re.search(r"drop rate ([\d.e+-]+)", err.getvalue()).group(1)
                log(f"harness headline: dedup capacity held on every step; drop rate {drop}")
            if not rehearse:
                if name == "retrieval":  # towers and the index only, as the reference
                    if any(counts.values()):
                        raise AssertionError(f"retrieval launched {counts}, not nothing")
                elif min(counts.values()) <= 0:
                    raise AssertionError(f"the {name} harness never launched "
                                         f"{[k for k, v in counts.items() if v <= 0]}")
                if name == "headline":
                    want = headline_launches(**{k: sizes[name][k] for k in
                                                ("cap", "batch", "steps")}, rounds=rounds)
                    if counts != want:
                        raise AssertionError(f"the headline launched {counts}, not {want} "
                                             f"({rounds} planning rounds)")
            add_counts(total, {"launches": counts})
            log(f"harness {name}: {secs:.1f} s; launches {counts} on {card}")
    finally:
        shutil.rmtree(HARNESS_DIR, ignore_errors=True)
    if not rehearse:
        check_static_arms(args.seed)

    # the user's entry point, in a process of its own
    env = dict(os.environ, PYTHONPATH=str(ROOT), MEEPO_BENCH_CAP=str(1 << 20),
               MEEPO_BENCH_BATCH=str(1 << 16), MEEPO_BENCH_STEPS="3")
    if rehearse:
        env.update(MEEPO_BENCH_CAP=str(args.capacity), MEEPO_BENCH_BATCH="1024",
                   MEEPO_BENCH_STEPS="2")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "meepoembedding_tpu_torch.bench.headline",
                           "--device", dev.type], capture_output=True, text=True, timeout=600,
                          cwd=str(ROOT), env=env)
    if proc.returncode != 0:
        raise AssertionError(f"python -m meepoembedding_tpu_torch.bench.headline exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    first = proc.stderr.splitlines()[0]
    if list(line) != HARNESS_KEYS["headline"] or first != ("cpu" if rehearse else card):
        raise AssertionError(f"the headline subprocess printed {line} after {first!r}")
    log(f"harness: python -m meepoembedding_tpu_torch.bench.headline at "
        f"{env['MEEPO_BENCH_CAP']} slots in {time.perf_counter() - t0:.1f} s: {json.dumps(line)}")
    return total


# --- the random-row copy probe (K6, K7) -------------------------------------------

DMA_KEYS = ["metric", "value", "unit", "best_amortized_ns_per_row", "library_take_ns_per_row",
            "sweep", "w_effective", "blocks_per_sm", "copies_in_flight", "row_gather_shipped"]
DMA_MAIN = (1, 32)  # the (R, W) of the kernels line; the other points go under `shapes`


def dma_sweeps() -> dict:
    """{kernel name: (its R values, its W values)}: bench_dma.py's sweeps."""
    from meepoembedding_tpu_torch.bench import dma

    return {"row_block_gather": (dma.GATHER_R, dma.GATHER_W),
            "row_block_scatter": (dma.SCATTER_R, dma.SCATTER_W)}


def check_dma_kernels(seed: int, dev, nrow: int, n: int) -> dict:
    """K6 and K7 against their plain versions, bit for bit, at every (R, W)
    of bench_dma.py's sweeps on an [nrow, 128] f32 plane, W capped at the
    ring that fits (`max_ring`): every W of an R gives the plain version's
    bits, so every W gives the same. The
    gather's n bases are random with the clip edge in front (below 0, at
    and above nrow - R, the int32 extremes). The scatter writes random rows
    into disjoint blocks: distinct multiples of 32, and the bases -7 and
    nrow + 5, which clip into block 0 and the top block, where no other
    base goes. Then a ring that does not fit must be refused. Returns
    {(kernel, R, W): max |kernel - plain|}."""
    from meepoembedding_tpu_torch.kernels.row_block_copy import max_ring

    g = torch.Generator(device=dev).manual_seed(seed + 313)
    plane = torch.randn((nrow, LANES), device=dev, generator=g)
    errs = {}
    for name, (rs, ws) in dma_sweeps().items():
        gather = name == "row_block_gather"
        for R in rs:
            if gather:
                base = torch.randint(0, nrow - R + 1, (n,), device=dev, dtype=torch.int32,
                                     generator=g)
                edge = [-(2**31), -7, 0, nrow - R, nrow - R + 1, nrow - 1, nrow, nrow + 5,
                        2**31 - 1]
                base[:len(edge)] = torch.tensor(edge, dtype=torch.int32, device=dev)
                want = row_block_gather_plain(plane, base, R)
                what = "random bases, the clip edge in front"
            else:
                blocks = torch.randperm(nrow // 32 - 2, device=dev, generator=g)[:n] + 1
                base = (blocks * 32).to(torch.int32)
                base[0], base[1] = nrow + 5, -7
                upd = torch.randn((base.shape[0] * R, LANES), device=dev, generator=g)
                want = row_block_scatter_plain(plane.clone(), base, upd, R)
                what = "disjoint blocks of random rows, clipped at both ends"
            for W in ws:
                w = min(W, max_ring(R))
                got = (row_block_gather(plane, base, R, w) if gather
                       else row_block_scatter(plane.clone(), base, upd, R, w))
                sync(dev)
                errs[(name, R, W)] = max_abs_err(f"{name} R={R} W={w}", got, want)
                del got
            log(f"check {name} R={R}, W in {list(ws)} (run at "
                f"{[min(W, max_ring(R)) for W in ws]}): [{nrow}, 128] f32, {base.shape[0]} "
                f"descriptors, {what}: bit-exact, the same bits at every W")
            del want
    try:
        row_block_gather(plane, base[:8], 32, 32)
    except ValueError as e:
        log(f"check row_block_gather: a ring that does not fit is refused ({e})")
    else:
        raise AssertionError("row_block_gather took a ring that does not fit a block")
    del plane
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return errs


def dma_sizes(rehearse: bool) -> dict:
    """The knobs of the dma phase's harnesses: their defaults on the card,
    tiny ones in a rehearsal."""
    if not rehearse:
        return {"dma": {}, "row_kernels": {}, "dedup_variants": {}}
    return {"dma": dict(rows=4096, desc=256, iters=1, repeat=1),
            "row_kernels": dict(rows=4096, n=256, steps=1),
            "dedup_variants": dict(n=4096, ucap=4096, steps=1)}


def dma_phase(args, dev, card: str) -> dict:
    """The dma phase (module docstring): the checks, then the three
    harnesses with every counter set to 0 just before them. Returns their
    launches and results and the checks' errors."""
    from meepoembedding_tpu_torch.bench import dedup_variants, dma, row_kernels

    rehearse = dev.type == "cpu"
    earlier = dma_launches()
    if any(earlier.values()):
        raise AssertionError(f"K6 / K7 launched before the dma phase: {earlier}")
    gc.collect()
    if not rehearse:
        torch.cuda.empty_cache()
    nrow, n = (4096, 256) if rehearse else (1 << 22, 1 << 16)  # bench_dma.py's plane and calls
    t0 = time.perf_counter()
    errs = check_dma_kernels(args.seed, dev, nrow, n)
    log(f"dma: checks passed in {time.perf_counter() - t0:.1f} s")

    sizes = dma_sizes(rehearse)
    reset_launches()
    for k in DMA_KERNELS:
        k.launches = 0
    results = {}
    t0 = time.perf_counter()
    for name, mod in (("dma", dma), ("row_kernels", row_kernels),
                      ("dedup_variants", dedup_variants)):
        err, held = io.StringIO(), []
        before = {**launches(), **dma_launches()}
        try:
            with contextlib.redirect_stderr(err), held_kernels(held):
                results[name] = mod.run(device=dev, **sizes[name])
        finally:
            for line in err.getvalue().splitlines():
                log(f"dma {name} | {line}")
        log(f"dma {name}: {held_summary(held)}")
        ran = {k: v - before[k] for k, v in {**launches(), **dma_launches()}.items()
               if v > before[k]}
        if ran and not held:
            raise AssertionError(f"dma {name} launched {ran} and no kernel call was held")
        log(f"dma {name}: {json.dumps(results[name])}")
    counts = {**launches(), **dma_launches()}
    log(f"dma: path finished in {time.perf_counter() - t0:.1f} s; launches {counts} on {card}")
    if list(results["dma"]) != DMA_KEYS:
        raise AssertionError(f"bench.dma printed keys {list(results['dma'])}, not {DMA_KEYS}")
    res = results["dma"]
    if len(res["w_effective"]) != 14 or (not rehearse and not all(res["blocks_per_sm"].values())):
        raise AssertionError(f"bench.dma: w_effective {res['w_effective']}, blocks_per_sm "
                             f"{res['blocks_per_sm']}")
    if not rehearse:
        for k in ("row_block_gather", "row_block_scatter", "row_gather", "row_scatter_add",
                  "row_scatter_set"):
            if counts[k] <= 0:
                raise AssertionError(f"the dma path never launched {k}")
    return {"counts": counts, "earlier": earlier, "errs": errs, "nrow": nrow, "n": n}


def time_dma_kernels(res: dict) -> dict:
    """K6 and K7 at every point of the sweeps on bench_dma.py's stream (8
    index sets of 2^16 distinct rows of a [2^22, 128] f32 plane, as
    bench.dma makes them): kernel, plain and (at R = 1, where one call
    computes the same rows: index_select, index_put_) library times
    (`time_ms`; 5 x 24 calls at the main point, 3 x 8 elsewhere), the bytes
    bound (2 n R 512 + 4 n bytes at 3.35 TB/s), and at the main point the
    profiler's device time and the host time of a call. {kernel name:
    [records, the main point first]}."""
    from meepoembedding_tpu_torch.bench import dma
    from meepoembedding_tpu_torch.kernels.row_block_copy import max_ring

    dev = torch.device("cuda")
    nrow, n = res["nrow"], res["n"]
    plane = torch.full((nrow, LANES), 0.5, device=dev)
    idxs = [s[0] for s in dma.index_sets(nrow, n, 8, 1, dev)]
    g = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for name, (rs, ws) in dma_sweeps().items():
        gather = name == "row_block_gather"
        pts = sorted(((R, W) for R in rs for W in ws), key=lambda p: p != DMA_MAIN)
        out[name] = []
        for R, W in pts:
            w = min(W, max_ring(R))
            if gather:
                kern = [lambda i=i, R=R, w=w: row_block_gather(plane, i, R, w) for i in idxs]
                plain = [lambda i=i, R=R: row_block_gather_plain(plane, i, R) for i in idxs]
                lib = [lambda i=i: torch.index_select(plane, 0, i) for i in idxs]
            else:
                upd = torch.randn((n * R, LANES), device=dev, generator=g)
                kern = [lambda i=i, R=R, w=w, u=upd: row_block_scatter(plane, i, u, R, w)
                        for i in idxs]
                plain = [lambda i=i, R=R, u=upd: row_block_scatter_plain(plane, i, u, R)
                         for i in idxs]
                lib = [lambda i=i, u=upd: plane.index_put_((i,), u) for i in idxs]
            main = (R, W) == DMA_MAIN
            depth = () if main else (3, 8)
            bound_ms = (2 * n * R * 512 + 4 * n) / HBM_BYTES_PER_S * 1e3
            e = {"label": f"{'gather' if gather else 'scatter'}_R{R}_W{W}",
                 "shape": f"[{nrow}, 128] f32, n={n}, R={R}, W={w}"
                          + (f" (asked {W})" if w != W else ""),
                 "ms": time_ms(kern, *depth), "device_ms": None, "kernel_ms": None,
                 "plain_ms": time_ms(plain, *depth),
                 "library_ms": time_ms(lib, *depth) if R == 1 else None,
                 "bound_ms": bound_ms, "max_abs_err": res["errs"][(name, R, W)]}
            if main:
                for k, ms in zip(("device_ms", "kernel_ms"), device_ms(kern, "row_block_copy")):
                    e[k] = ms if ms is None or ms >= bound_ms else None
                e["host_us"] = host_time(name, kern[0])
            out[name].append(e)
            log(f"timing {name} [{e['label']}] {e['shape']}: kernel {e['ms']:.4f} ms (device "
                f"{fmt_ms(e['device_ms'])}, {fmt_ms(e['kernel_ms'])} in the kernel), plain "
                f"{e['plain_ms']:.4f} ms, library {fmt_ms(e['library_ms'])}, bound "
                f"{bound_ms:.4f} ms (bytes); max |kernel - plain| {e['max_abs_err']}")
            if not gather:
                del upd
    del plane
    torch.cuda.empty_cache()
    return out


# --- main ----------------------------------------------------------------------

# --- the model zoo ---------------------------------------------------------------

ZOO_KINDS = ("ctr_mlp", "dcn", "deepfm", "din", "bst", "two_tower")
ZOO_BAG_LEN = 20  # behaviour-sequence length of the BST paper (Chen et al. 2019)


def zoo_model_cfg(kind: str) -> ModelConfig:
    """The default ModelConfig widths (13 dense, 26 sparse, dim 32, bottom
    128-64-32, top 256-128-1, 3 cross layers); two-tower with logQ."""
    return ModelConfig(kind=kind, logq_correction=kind == "two_tower")


def margin_atol(tr) -> float:
    """The two-tower's logits are margins, differences of two scores of
    magnitude up to tau = exp(log_tau): their rounding scales with tau, so
    their atol is 1e-5 * tau (rtol 1e-5 on the scores). 1e-6 otherwise."""
    if tr.model_cfg.kind != "two_tower":
        return 1e-6
    return 1e-5 * float(torch.exp(tr.model.log_tau.detach().cpu()))


def zero_grad_leaves(mc) -> set:
    """Tower leaves whose gradient is 0 in exact arithmetic: DIN's last
    attention bias shifts every logit of a softmax alike. Both devices move
    it by rounding noise scaled up by Adam; it reaches no output."""
    return {2 * len(mc.attention_mlp) + 1} if mc.kind == "din" else set()


def check_zoo_parity(seed: int, dev, bsz: int) -> dict:
    """3 Trainer steps of each new kind on `dev` and on the CPU from one
    state (tower from one CPU generator, empty 2^16-slot table, the same
    batches of `bsz` examples; DIN and BST on bags of 5, two-tower with
    logQ): key, freq, last, cnt, ovf and counters equal; values,
    accumulators, loss and logits within rtol 1e-5 / atol 1e-6 (margins:
    `margin_atol`); dense params within atol 1e-4, as `check_train_parity`
    holds them. Returns the `dev` trainers and their last batches."""
    out = {}
    for kind in ZOO_KINDS:
        mc = zoo_model_cfg(kind)
        # the two-tower's tower is held still (dense lr 0): Adam turns its
        # near-zero item-tower gradients (in-batch softmax rows sum to zero)
        # into steps of ~lr whose sign is rounding, which then move every
        # embedding gradient (PERF.md, "Findings")
        lr = 0.0 if kind == "two_tower" else RunConfig.dense_learning_rate
        run_cfg = RunConfig(batch_size=bsz, steps=3, seed=seed, dense_learning_rate=lr)
        bag = 5 if kind in ("din", "bst") else 1
        stream = SyntheticStream(SyntheticConfig(batch_size=bsz, seed=seed + 5, bag_len=bag))
        batches = list(stream.batches(3))
        cpu, card = (Trainer(run_cfg, TableConfig(dim=32, capacity=1 << 16), mc, device=d)
                     for d in (torch.device("cpu"), dev))
        res = {d: [(tr.train_step(b)["loss"], tr.last_logits.cpu()) for b in batches]
               for d, tr in (("cpu", cpu), (dev, card))}
        for name in ("key_hi", "key_lo", "freq", "last", "cnt", "ovf", "counters"):
            if not torch.equal(getattr(card.shard, name).cpu(), getattr(cpu.shard, name)):
                raise AssertionError(f"zoo parity {kind}: {name} differs between {dev} and CPU")
        skip = zero_grad_leaves(mc)
        params = [(j, p) for j, p in enumerate(card.params) if j not in skip]
        errs = {}
        for name, got, want, tol in (
            ("values", card.shard.values, cpu.shard.values, dict(rtol=1e-5, atol=1e-6)),
            ("accum", card.shard.opt_rowwise[0], cpu.shard.opt_rowwise[0],
             dict(rtol=1e-5, atol=1e-6)),
            ("loss", torch.tensor([r[0] for r in res[dev]]),
             torch.tensor([r[0] for r in res["cpu"]]), dict(rtol=1e-5, atol=1e-6)),
            ("logits", torch.stack([r[1] for r in res[dev]]),
             torch.stack([r[1] for r in res["cpu"]]), dict(rtol=1e-5, atol=margin_atol(cpu))),
            ("params", torch.cat([p.detach().reshape(-1) for _, p in params]),
             torch.cat([cpu.params[j].detach().reshape(-1) for j, _ in params]),
             dict(rtol=0.0, atol=1e-4)),
        ):
            got = got.cpu()
            errs[name] = float((got - want).abs().max())
            torch.testing.assert_close(got, want, **tol,
                                       msg=lambda m, n=name: f"zoo parity {kind} {n}: {m}")
        log(f"check zoo parity {kind}: 3 steps of {bsz} x 26{' x 5' if bag > 1 else ''} ids, "
            f"{dev} vs CPU: planes and counters equal ({card.counters()}); max |{dev} - CPU| "
            f"{errs}")
        out[kind] = (card, batches[-1])
    return out


def zoo_train(kind: str, table, batches, dev, card: str, seed: int) -> dict:
    """Warm-up steps, then timed ones, of a `kind` Trainer on the live table
    (in place), from `batches` (an iterator). Fails on a non-finite loss,
    drops above 1% of inserts, or (on the card) other per-step launches than
    the train phase's. On the card it then steps again on the last 5
    batches, held in memory (timed: no input thread beside the steps), and
    profiles 2 more."""
    mc = zoo_model_cfg(kind)
    warm, nsteps = (1, 2) if dev.type == "cpu" else (5, TRAIN_STEPS)
    tr = Trainer(RunConfig(steps=warm + nsteps, seed=seed), table.cfg, mc, device=dev,
                 generator=torch.Generator().manual_seed(seed), shard=table.shard)
    before, at, rounds0 = tr.counters(), launches(), plan_rounds()
    losses, lat, shape, held = [], [], None, []
    for i in range(warm + nsteps):
        b = next(batches)
        held = (held + [b])[-5:]
        shape = b["ids"].shape
        t0 = time.perf_counter()
        loss = tr.train_step(b)["loss"]  # reading the loss syncs
        lat.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if not np.isfinite(loss):
            raise AssertionError(f"zoo {kind} step {i}: loss {loss}")
    sync(dev)
    steps = warm + nsteps
    after = tr.counters()
    diff = {k: after[k] - before[k] for k in ("hits", "inserts", "drops")}
    now = launches()
    per = {k: (now[k] - at[k]) / steps for k in now}
    rounds = plan_rounds() - rounds0
    lat = np.asarray(lat[warm:])
    bsz, ids_per_step = shape[0], int(np.prod(shape))
    log(f"zoo {kind}: {warm} warm-up + {nsteps} timed steps of {' x '.join(map(str, shape))} "
        f"ids: step p50 {np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms; "
        f"{bsz * nsteps / (lat.sum() / 1e3):.0f} examples/s, "
        f"{ids_per_step * nsteps / (lat.sum() / 1e3):.0f} ids/s on {card}; hits "
        f"{diff['hits']}, inserts {diff['inserts']}, drops {diff['drops']}; loss first "
        f"{losses[0]:.6f}, last {losses[-1]:.6f}; launches per step: "
        + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
        + f", planning rounds {rounds / steps:.2f}")
    if diff["drops"] > 0.01 * max(1, diff["inserts"]):
        raise AssertionError(f"zoo {kind}: {diff['drops']} drops > 1% of {diff['inserts']} "
                             "inserts")
    out = {"kind": kind, "shape": list(shape), "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "examples_per_s": bsz * nsteps / (lat.sum() / 1e3),
           "ids_per_s": ids_per_step * nsteps / (lat.sum() / 1e3), "drops": diff["drops"],
           "inserts": diff["inserts"], "loss_first": losses[0], "loss_last": losses[-1]}
    if dev.type == "cuda":
        want = {"row_scatter_set": 1, "row_scatter_add": 1, "row_merge_add": 3,
                "row_gather": 2 + rounds / steps, "bucket_probe": 1}
        for name, w in want.items():
            if abs(per[name] - w) > 1e-9:
                raise AssertionError(f"zoo {kind}: {name} launched {per[name]:.2f} times a "
                                     f"step, not {w:.2f}")
        again = []
        for b in held:
            t0 = time.perf_counter()
            tr.train_step(b)
            again.append((time.perf_counter() - t0) * 1e3)
        out["held_p50_ms"] = float(np.median(again))
        log(f"zoo {kind}: {len(held)} more steps on the last batches, held in memory: p50 "
            f"{out['held_p50_ms']:.3f} ms")
        run_profiled(f"zoo {kind}", lambda: [tr.train_step(b) for b in held[-2:]], 2, "step")
    return out


def zoo_score(kind: str, tr, batch, root: Path, dev) -> None:
    """Save a trainer's checkpoint, restore it into a ScoringService and
    score one request: the scores must equal its eval_step's logits
    through a sigmoid (rtol 1e-5)."""
    path = root / f"ckpt-{kind}"
    tr.save_checkpoint(str(path))
    svc = ScoringService(str(path), tr.table_cfg, tr.model_cfg, device=dev)
    got = svc.score(batch["dense"], batch["ids"])
    want = torch.sigmoid(tr.eval_step(batch)["logits"]).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    log(f"zoo {kind}: a checkpoint restored into a ScoringService scores "
        f"{' x '.join(map(str, batch['ids'].shape))} ids as the trainer's eval_step "
        f"(max |diff| {float(np.abs(got - want).max())})")
    shutil.rmtree(path)


def zoo(args, table, dev, card: str) -> list:
    """The model-zoo phase (module docstring): (a) each new kind card vs
    CPU, (b) the Criteo path for ctr_mlp, dcn and deepfm, (c) DIN and BST
    on bags and the two-tower with logQ, all on the live table, (d) DCN and
    DIN checkpoints scored through a ScoringService."""
    root = ROOT / "build" / "chip_smoke" / "zoo"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rehearse = dev.type == "cpu"
    bsz = args.batch if rehearse else TRAIN_BATCH
    steps = 3 if rehearse else 5 + TRAIN_STEPS
    bag_len = 4 if rehearse else ZOO_BAG_LEN  # a rehearsal's table is 2^14 slots
    try:
        parity = check_zoo_parity(args.seed, dev, args.batch if rehearse else 512)
        tsv = root / "signal.tsv"
        t0 = time.perf_counter()
        write_synthetic_criteo_signal(str(tsv), bsz * steps, seed=args.seed)
        log(f"zoo: wrote {bsz * steps} Criteo-format lines (planted signal, Zipf s = 1.05, "
            f"20,000 values a feature) in {time.perf_counter() - t0:.1f} s")
        results = []
        for i, kind in enumerate(("ctr_mlp", "dcn", "deepfm")):
            stream = PrefetchStream(CriteoStream(str(tsv), bsz), depth=2)
            if stream.parser != "native":
                raise AssertionError(f"CriteoStream parses with {stream.parser!r}, not native")
            results.append(zoo_train(kind, table, iter(stream.batches(steps)), dev, card,
                                     args.seed + 20 + i))
        t0 = time.perf_counter()
        bags = list(SyntheticStream(SyntheticConfig(batch_size=bsz, seed=args.seed + 31,
                                                    bag_len=bag_len)).batches(steps))
        onehot = list(SyntheticStream(SyntheticConfig(batch_size=bsz,
                                                      seed=args.seed + 37)).batches(steps))
        log(f"zoo: made {steps} batches of {bsz} x 26 x {bag_len} and of {bsz} x 26 ids "
            f"in {time.perf_counter() - t0:.1f} s")
        for i, (kind, batches) in enumerate((("din", bags), ("bst", bags),
                                             ("two_tower", onehot))):
            results.append(zoo_train(kind, table, iter(batches), dev, card,
                                     args.seed + 23 + i))
        for kind in ("dcn", "din"):
            zoo_score(kind, *parity[kind], root, dev)
    finally:
        shutil.rmtree(root.parent, ignore_errors=True)
    return results


# --- the command line ----------------------------------------------------------

CLI_DIR = ROOT / "build" / "chip_smoke_cli"
CLI_TRAIN = (5, 30)  # warm-up and timed steps of the train subprocess
CLI_BENCH = ("1e8", "524288", "20")  # --rows, --batch, --steps (README's bench commands)
CLI_CPU_CAP = 1 << 21  # card against CPU: the train checkpoint's rows at load < 0.5
# the printed scores carry 6 decimals: the serve phase's rtol 1e-5 / atol 1e-6 plus
# half a unit of the 6th decimal (a score against a service's), or a unit (two prints)
SCORE_TOL = dict(rtol=1e-5, atol=1.5e-6)
PRINTED_TOL = dict(rtol=1e-5, atol=2e-6)
AUC_TOL = 1e-6  # a logit that crosses one of the 8192 bins moves the AUC by ~1/(npos nneg)


def cli_sets(args, capacity: int, steps: int, batch: int) -> list:
    """--set of config 2 (dim 32, the default ModelConfig) at `capacity` slots."""
    return ["--set", "table.dim=32", f"table.capacity={capacity}", f"run.batch_size={batch}",
            f"run.steps={steps}", f"run.seed={args.seed}"]


def cli_call(argv: list, dev, expect_rc: int = 0) -> dict:
    """One in-process `cli.main(argv --device <dev>)`: its stdout's JSON
    lines, stderr, seconds, and the kernel launches and insert-planning
    rounds it made. Fails unless it exits with `expect_rc`."""
    out, err = io.StringIO(), io.StringIO()
    at, rounds = launches(), plan_rounds()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([*argv, "--device", dev.type])
    sync(dev)
    secs = time.perf_counter() - t0
    now = launches()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rc != expect_rc:
        raise AssertionError(f"cli {argv[0]} exited {rc}, not {expect_rc}: {err.getvalue()[-2000:]}")
    text = out.getvalue()
    # one JSON object a line (ckpt-inspect's indented object is read from "out")
    return {"lines": [json.loads(x) for x in text.splitlines()
                      if x.startswith("{") and x.endswith("}")],
            "out": text, "err": err.getvalue(), "s": secs,
            "launches": {k: now[k] - at[k] for k in now},
            "rounds": plan_rounds() - rounds}


def hold_launches(what: str, res: dict, want: dict, dev) -> None:
    """Fail unless a command launched exactly `want` (kernel -> launches;
    row_gather without its planning rounds, which are added here)."""
    if dev.type != "cuda":
        return
    want = {k: want.get(k, 0) for k in res["launches"]}
    want["row_gather"] += res["rounds"]
    if res["launches"] != want:
        raise AssertionError(f"{what} launched {res['launches']} with {res['rounds']} planning "
                             f"rounds, not {want}")


def restore_batches(path) -> int:
    """Insert batches of a one-shard checkpoint's restore into one shard:
    each data file in batches of `restore_shards`' size."""
    m = ckpt_io.read_manifest(str(path))
    total = max(1, sum(m["counts"]))
    b = 1024
    while b < min(ckpt_io._RESTORE_BATCH, total):
        b *= 2
    b = min(b, ckpt_io._RESTORE_BATCH)
    n = 0
    for fp in ckpt_io._shard_files(ckpt_io._data_dir(str(path), m), 0):
        with np.load(fp) as z:
            n += -(-z["ids"].shape[0] // b)
    return n


def part_files(path) -> int:
    m = ckpt_io.read_manifest(str(path))
    return len(ckpt_io._shard_files(ckpt_io._data_dir(str(path), m), 0))


def served_batches(batches: int, dev) -> int:
    """The probe-only lookups the wrappers count for `batches` one-hot
    scoring batches of one size through a ScoringService: on the card their
    size's capture runs the chain twice and each replay calls no wrapper."""
    return min(batches, 1) * 2 if dev.type == "cuda" else batches


def restore_launches(path, batches: int, steps: int = 0) -> dict:
    """A restore (3 sets and 1 probe a batch) followed by `batches`
    probe-only scoring batches (1 probe, 2 gathers) or `steps` train steps
    (1 probe, 2 gathers, 1 set, 1 fetch-add, 3 K1)."""
    nb = restore_batches(path)
    return {"row_scatter_set": 3 * nb + steps, "row_gather": 2 * (batches + steps),
            "bucket_probe": nb + batches + steps, "row_scatter_add": steps,
            "row_merge_add": 3 * steps}


def bench_launches(rows: float, batch: int, steps: int, update: bool) -> dict:
    """bench-lookup/update: the prefill's insert batches (1 probe, 3 sets),
    then 1 + 3 x steps cycles of a lookup (1 probe; 2 gathers: the values,
    the rows by the inverse; 1 set) and, to update, the segment sum and the
    sparse update (3 K1, 1 fetch-add)."""
    prefill = -(-int(rows * 0.8) // min(batch, 1 << 20))
    cycles = 1 + 3 * steps
    return {"row_scatter_set": 3 * prefill + cycles, "row_gather": 2 * cycles,
            "bucket_probe": prefill + cycles,
            "row_scatter_add": cycles if update else 0,
            "row_merge_add": 3 * cycles if update else 0}


def add_counts(total: dict, res: dict) -> None:
    for k, v in res["launches"].items():
        total[k] = total.get(k, 0) + v


def cli_phase(args, dev, card: str) -> dict:
    """The command line on the card (module docstring, `cli` phase, part
    a): train through `python -m`, the checkpoint commands, train
    --restore, card against CPU, the bench commands. Returns the launches
    of its in-process commands."""
    rehearse = dev.type == "cpu"
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    counts: dict = {}
    cap = args.capacity
    batch = args.batch if rehearse else TRAIN_BATCH
    warm, timed = (1, 2) if rehearse else CLI_TRAIN
    try:
        # the host time of the batches the CLI's train makes inside its step loop
        t0 = time.perf_counter()
        list(SyntheticStream(SyntheticConfig(batch_size=batch, seed=args.seed)).batches(timed))
        gen_ms = (time.perf_counter() - t0) / timed * 1e3
        log(f"cli: SyntheticStream makes a batch of {batch} x 26 ids in {gen_ms:.3f} ms on the "
            f"host (mean of {timed}); the CLI's train makes each inside its step loop")

        # (1) train from scratch through the module entry point, in a subprocess
        ck = CLI_DIR / "train"
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cmd = [sys.executable, "-m", "meepoembedding_tpu_torch", "train", "--data", "synthetic",
               "--ckpt-dir", str(ck), "--device", dev.type,
               *cli_sets(args, cap, warm + timed, batch), f"run.log_every={warm}"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT,
                              env=dict(os.environ, PYTHONPATH=str(ROOT)))
        sub_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"python -m meepoembedding_tpu_torch train exited "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
        logs = [x for x in lines if "loss" in x]
        if lines[-1].get("steps") != warm + timed or not all(np.isfinite(x["loss"]) for x in logs):
            raise AssertionError(f"train subprocess: final line {lines[-1]}, losses "
                                 f"{[x['loss'] for x in logs]}")
        first = next(x for x in logs if x["step"] == warm)
        last = logs[-1]
        # examples_per_sec is cumulative: the seconds at step `warm` and at the end
        t_w = warm * batch / first["examples_per_sec"]
        t_e = last["step"] * batch / last["examples_per_sec"]
        step_ms = (t_e - t_w) / (last["step"] - warm) * 1e3
        if last["ctr_drops"] > 0.01 * max(1, last["ctr_inserts"]):
            raise AssertionError(f"train subprocess: {last['ctr_drops']} drops of "
                                 f"{last['ctr_inserts']} inserts")
        log(f"cli: python -m meepoembedding_tpu_torch train: {warm} + {timed} steps of {batch} x "
            f"26 ids at {cap} slots in {sub_s:.1f} s (process start, build load, table, "
            f"checkpoint); mean step {step_ms:.3f} ms over steps {warm + 1}-{last['step']} "
            f"({timed * batch / (t_e - t_w):.0f} examples/s, from the log's cumulative "
            f"examples/s); inserts {last['ctr_inserts']}, drops {last['ctr_drops']}, loss "
            f"{logs[0]['loss']:.6f} -> {last['loss']:.6f}, final AUC {lines[-1]['final_auc']:.4f}"
            f" on {card}")

        # (2) inspect, export (npz) and import of that checkpoint
        ins = cli_call(["ckpt-inspect", str(ck)], dev)
        m = json.loads(ins["out"])
        exp = cli_call(["ckpt-export", str(ck), "--out", str(CLI_DIR / "rows.npz")], dev)
        rows = exp["lines"][-1]["rows"]
        if m["total_rows"] != sum(m["counts"]) or m["total_rows"] != rows or rows == 0:
            raise AssertionError(f"ckpt-inspect counts {m['counts']} / total {m['total_rows']} "
                                 f"against {rows} exported rows")
        imp = cli_call(["ckpt-import", str(CLI_DIR / "rows.npz"), "--out",
                        str(CLI_DIR / "imported")], dev)
        if imp["lines"][-1]["rows_imported"] != rows:
            raise AssertionError(f"ckpt-import: {imp['lines'][-1]}")
        with np.load(CLI_DIR / "rows.npz") as z:
            want = {"ids": z["ids"], "values": z["values"]}
        got = {k: np.concatenate([d[k] for d in ckpt_io.iter_rows(str(CLI_DIR / "imported"))])
               for k in ("ids", "values")}
        o_w, o_g = np.argsort(want["ids"]), np.argsort(got["ids"])
        if not (np.array_equal(got["ids"][o_g], want["ids"][o_w])
                and np.array_equal(got["values"][o_g].view(np.int32),
                                   want["values"][o_w].view(np.int32))):
            raise AssertionError("the imported checkpoint's rows differ from the export")
        chunks = -(-rows // cli.IMPORT_CHUNK)
        hold_launches("ckpt-import", imp, {"row_scatter_set": 3 * chunks, "bucket_probe": chunks,
                                           "row_gather": 3 * part_files(CLI_DIR / "imported")},
                      dev)
        for what, r in (("ckpt-inspect", ins), ("ckpt-export", exp)):
            hold_launches(what, r, {}, dev)
        for r in (ins, exp, imp):
            add_counts(counts, r)
        log(f"cli: ckpt-inspect {m['total_rows']} rows (counts {m['counts']}) in {ins['s']:.2f} s; "
            f"ckpt-export npz {rows} rows in {exp['s']:.2f} s; ckpt-import in {imp['s']:.2f} s "
            f"({chunks} assign chunks, launches {imp['launches']}); imported rows equal the "
            f"export bit for bit")
        shutil.rmtree(CLI_DIR / "imported")
        (CLI_DIR / "rows.npz").unlink()

        # (3) train --restore of the checkpoint, 5 steps, held to the train phase's launches
        rs = cli_call(["train", "--restore", str(ck), *cli_sets(args, cap, 5, batch)], dev)
        if rs["lines"][-1]["steps"] != warm + timed + 5:
            raise AssertionError(f"train --restore: {rs['lines'][-1]}")
        hold_launches("train --restore", rs, restore_launches(ck, 0, steps=5), dev)
        add_counts(counts, rs)
        log(f"cli: train --restore + 5 steps in {rs['s']:.2f} s; launches {rs['launches']} with "
            f"{rs['rounds']} planning rounds ({restore_batches(ck)} restore batches)")

        # (4) card against CPU: eval and serve of the checkpoint on both devices
        small = cli_sets(args, min(cap, CLI_CPU_CAP), 2, batch)
        outs = {}
        for d in (dev, torch.device("cpu")):
            ev = cli_call(["eval", "--ckpt", str(ck), *small], d)
            sv = cli_call(["serve", "--ckpt", str(ck), "--emit", str(batch), *small], d)
            outs[d.type] = (ev, sv)
        (ev_d, sv_d), (ev_c, sv_c) = outs[dev.type], outs["cpu"]
        e_d, e_c = ev_d["lines"][-1], ev_c["lines"][-1]
        if (e_d["examples"], e_d["batches"]) != (e_c["examples"], e_c["batches"]) or \
                abs(e_d["auc"] - e_c["auc"]) > AUC_TOL:
            raise AssertionError(f"eval on {dev.type} {e_d} against the CPU's {e_c}")
        np.testing.assert_allclose(e_d["mean_loss"], e_c["mean_loss"], rtol=1e-5)
        for a, b in zip(sv_d["lines"], sv_c["lines"]):
            np.testing.assert_allclose(a["scores"], b["scores"], **PRINTED_TOL)
        if len(sv_d["lines"]) != 2 or len(sv_c["lines"]) != 2:
            raise AssertionError("serve printed other than 2 batches")
        hold_launches("eval", ev_d, restore_launches(ck, 2), dev)
        hold_launches("serve", sv_d, restore_launches(ck, served_batches(2, dev)), dev)
        add_counts(counts, ev_d)
        add_counts(counts, sv_d)
        log(f"cli: eval and serve, {dev.type} against the CPU, at {min(cap, CLI_CPU_CAP)} slots: "
            f"AUC {e_d['auc']:.6f} / {e_c['auc']:.6f}, mean loss {e_d['mean_loss']:.7f} / "
            f"{e_c['mean_loss']:.7f}, {2 * batch} scores within rtol 1e-5 / atol 2e-6 (eval "
            f"{ev_d['s']:.2f} / {ev_c['s']:.2f} s, serve {sv_d['s']:.2f} / {sv_c['s']:.2f} s)")
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)

    # (5) bench-lookup and bench-update at README's size
    rows_, bbatch, bsteps = ((str(cap), str(batch), "2") if rehearse else CLI_BENCH)
    bench = {}
    for name in ("bench-lookup", "bench-update"):
        r = cli_call([name, "--rows", rows_, "--batch", bbatch, "--steps", bsteps], dev)
        line = r["lines"][-1]
        if list(line) != ["metric", "value", "unit", "rows", "ms_per_step"] or line["value"] <= 0:
            raise AssertionError(f"{name}: {line}")
        hold_launches(name, r, bench_launches(float(rows_), int(bbatch), int(bsteps),
                                              name == "bench-update"), dev)
        add_counts(counts, r)
        log(json.dumps(line))
        log(f"cli: {name} --rows {rows_} --batch {bbatch} --steps {bsteps} in {r['s']:.1f} s "
            f"(prefill included) on {card}; launches {r['launches']} with {r['rounds']} "
            f"planning rounds")
        bench[name] = line
    return {"counts": counts, "train_step_ms": step_ms, "batch_gen_ms": gen_ms, "bench": bench}


def cli_serve_phase(args, res, dev, card: str) -> dict:
    """The command line on the serve phase's checkpoint (module docstring,
    `cli` phase, part b): serve and eval at the serve phase's width, held
    against its in-process ScoringService on the same batches. Returns
    the launches of the two commands."""
    svc, ck = res["svc"], res["ckpt"]
    nbatch = args.requests
    stream = SyntheticStream(SyntheticConfig(batch_size=args.batch, seed=args.seed))
    batches = list(stream.batches(nbatch))
    sv = cli_call(["serve", "--ckpt", str(ck), "--emit", str(args.batch),
                   *cli_sets(args, args.capacity, nbatch, args.batch)], dev)
    if len(sv["lines"]) != nbatch:
        raise AssertionError(f"serve printed {len(sv['lines'])} batches, not {nbatch}")
    probs = []
    for line, b in zip(sv["lines"], batches):
        p = svc.score(b["dense"], b["ids"])
        probs.append(p)
        np.testing.assert_allclose(line["scores"], p, **SCORE_TOL)
    lat = json.loads(sv["err"].strip().splitlines()[-1])
    hold_launches("serve", sv, restore_launches(ck, served_batches(nbatch, dev)), dev)
    log(f"cli: serve of the {args.ckpt_rows}-row checkpoint at {args.capacity} slots: {nbatch} "
        f"batches of {args.batch} in {sv['s']:.2f} s (restore included), latency a batch "
        f"{lat['serve_latency_ms']}; scores within rtol 1e-5 / atol 1.5e-6 of the serve phase's "
        f"ScoringService; launches {sv['launches']}")

    ev_steps = min(8, nbatch)
    ev = cli_call(["eval", "--ckpt", str(ck), *cli_sets(args, args.capacity, ev_steps,
                                                          args.batch)], dev)
    e = ev["lines"][-1]
    p = np.concatenate(probs[:ev_steps]).astype(np.float64)
    y = np.concatenate([b["label"] for b in batches[:ev_steps]]).astype(np.float64)
    want_loss = float(np.mean(-(y * np.log(p) + (1 - y) * np.log1p(-p))))
    auc = StreamingAUC()
    auc.update(torch.from_numpy(np.log(p) - np.log1p(-p)), torch.from_numpy(y))
    if e["examples"] != ev_steps * args.batch or abs(e["auc"] - auc.compute()) > AUC_TOL:
        raise AssertionError(f"eval {e} against the service's AUC {auc.compute()}")
    np.testing.assert_allclose(e["mean_loss"], want_loss, rtol=1e-5)
    hold_launches("eval", ev, restore_launches(ck, ev_steps), dev)
    log(f"cli: eval of that checkpoint: {e} in {ev['s']:.2f} s, equal to the service's scores' "
        f"AUC and loss; launches {ev['launches']}")
    counts: dict = {}
    add_counts(counts, sv)
    add_counts(counts, ev)
    return counts


def main() -> int:
    args = parse_args()
    table_ops.span = counted_span  # in every process: the rank processes count rounds too
    if args.col_rank is not None:
        return col_rank_main(args)
    if args.front_rank is not None:
        return front_rank_main(args)
    try:
        return run_phases(args)
    finally:
        shutil.rmtree(HTTP_DIR, ignore_errors=True)


def run_phases(args) -> int:
    rehearse = args.rehearse_on_cpu
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()

    if rehearse:
        cap_cpu_threads()
        cpu = torch.device("cpu")
        log("rehearsal on the CPU: plain versions, no build, no timing, no result")
        card = "the CPU (rehearsal)"
        cli_phase(args, cpu, card)
        try:
            res = serve(args, cpu, rng, card)
            int8(args, res, cpu, card)
            sharded_phase(args, res, cpu, card)
            colsharded_phase(args, cpu, card)
            cli_serve_phase(args, res, cpu, card)
            shutil.move(str(res["ckpt"]), str(HTTP_DIR / "serve_ckpt"))
        finally:
            shutil.rmtree(ROOT / "build" / "chip_smoke", ignore_errors=True)
        train(args, res["svc"].table, cpu, card)
        lifecycle_live(args, res["svc"].table, res["assigned"], cpu, card)
        lifecycle_depth(args, cpu, card)
        # fresh tables: the rehearsal's live one is full after the lifecycle
        for phase in (zoo, embed_phase):
            phase(args, DynamicEmbeddingTable(TableConfig(dim=32, capacity=args.capacity),
                                              device=cpu), cpu, card)
        retrieval(args, cpu, card)
        group_phase(args, cpu, card)
        group_sharded_phase(args, 0.0, cpu, card)
        sharded_http_phase(args, res["http_single"], cpu, card)
        entry_phase(args, cpu, card)
        harness_phase(args, cpu, card)
        dma_phase(args, cpu, card)
        log(f"rehearsal finished in {time.perf_counter() - t_start:.1f} s")
        return 1

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"card: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {', '.join(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name, report in _build.ptxas_reports.items():
        for line in report.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line or "Compiling" in line):
                log(f"build {name}: {line.strip()}")

    t0 = time.perf_counter()
    check_kernels(CHECK_ROWS_LOG2, args.seed)
    check_add_kernels(CHECK_ROWS_LOG2, args.seed)
    check_segment_sum(args.seed)
    pool_timings = check_segment_sum_gather(args.seed)
    check_train_parity(args.seed)
    probe_timings = pool_timings + time_bucket_probe(args.seed)
    log(f"kernels: checks passed in {time.perf_counter() - t0:.1f} s")

    # each path runs with the launch counters set to 0 just before it
    cuda = torch.device("cuda")
    # the command line first (cli, part a): its train subprocess then has the
    # card to itself but for the kernel checks' freed planes
    reset_launches()
    t0 = time.perf_counter()
    cli_res = cli_phase(args, cuda, card)
    cli_counts = {k: cli_res["counts"].get(k, 0) for k in launches()}
    log(f"cli: part a finished in {time.perf_counter() - t0:.1f} s; launches {cli_counts}")
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = serve(args, cuda, rng, card)
        serve_counts = launches()
        log(f"serve: path finished in {time.perf_counter() - t0:.1f} s; launches "
            f"{serve_counts}")
        for name in ("row_gather", "row_scatter_set"):
            if serve_counts[name] <= 0:
                raise AssertionError(f"the serving path never launched {name}")

        # int8 serving on the serve phase's checkpoint: gathers only
        reset_launches()
        t0 = time.perf_counter()
        q8 = int8(args, res, cuda, card)
        int8_counts = launches()
        log(f"int8: path finished in {time.perf_counter() - t0:.1f} s; launches {int8_counts}")
        # bucket_probe: the f32 service's scores that the int8 ones are held to
        if int8_counts["row_gather"] <= 0 or any(int8_counts[k] for k in int8_counts
                                                 if k not in ("row_gather", "bucket_probe")):
            raise AssertionError(f"int8 serving must launch row_gather and nothing else: "
                                 f"{int8_counts}")

        # the row-sharded layer on a world of one, on the serve checkpoint too
        reset_launches()
        t0 = time.perf_counter()
        sharded_phase(args, res, cuda, card)
        sharded_counts = launches()
        log(f"sharded: path finished in {time.perf_counter() - t0:.1f} s; launches "
            f"{sharded_counts} on {card}")
        for name, count in sharded_counts.items():
            if count <= 0:
                raise AssertionError(f"the sharded path never launched {name}")

        # the column-sharded table: two rank processes on the card, each
        # setting its counters to 0 just before its main path
        t0 = time.perf_counter()
        col = colsharded_phase(args, cuda, card)
        log(f"colsharded: phase finished in {time.perf_counter() - t0:.1f} s")
        for r in col["ranks"]:
            for name, count in r["launches"].items():
                if count <= 0:
                    raise AssertionError(f"colsharded rank {r['rank']} never launched {name}")

        # the command line's serve and eval on the serve checkpoint (cli, part b)
        reset_launches()
        t0 = time.perf_counter()
        for k, v in cli_serve_phase(args, res, cuda, card).items():
            cli_counts[k] += v
        log(f"cli: part b finished in {time.perf_counter() - t0:.1f} s; launches of the "
            f"phase {cli_counts} on {card}")
        for name, count in cli_counts.items():
            if count <= 0:
                raise AssertionError(f"the command line never launched {name}")
        # the serve checkpoint stays for the sharded_http phase
        shutil.move(str(res["ckpt"]), str(HTTP_DIR / "serve_ckpt"))
    finally:
        shutil.rmtree(ROOT / "build" / "chip_smoke", ignore_errors=True)

    reset_launches()
    t0 = time.perf_counter()
    tres = train(args, res["svc"].table, cuda, card)
    train_counts = launches()
    steps = tres["steps"]
    log(f"train: path finished in {time.perf_counter() - t0:.1f} s; launches {train_counts}; "
        f"per step: " + ", ".join(f"{k} {v / steps:.2f}" for k, v in train_counts.items()))
    for name, count in train_counts.items():
        if count <= 0:
            raise AssertionError(f"the training path never launched {name}")
    # one multi-plane set (the fresh keys' key_hi, key_lo, freq, last), one
    # fetch-add (the rowwise accumulator) and three K1 launches (the
    # unique-row values update; the segment sum's walk and combine pass) a
    # step
    for name, want in (("row_scatter_set", 1), ("row_scatter_add", 1), ("row_merge_add", 3),
                       ("bucket_probe", 1)):
        if train_counts[name] != want * steps:
            raise AssertionError(f"the train step launched {name} "
                                 f"{train_counts[name] / steps:.2f} times, not {want}")
    # gathers: the values read and the rows by the inverse, plus one a
    # planning round; none of the accumulator
    rounds = plan_rounds()
    max_rounds = tres["trainer"].spec.max_probe_rounds
    log(f"train: row_gather {train_counts['row_gather'] / steps:.2f} a step, insert planning "
        f"{rounds / steps:.2f} rounds a step")
    if (train_counts["row_gather"] != 2 * steps + rounds
            or not 0 <= rounds <= max_rounds * steps):
        raise AssertionError(f"the train steps launched row_gather {train_counts['row_gather']} "
                             f"times in {steps} steps of {rounds} planning rounds, not 2 a step "
                             f"+ 1 a round (at most {max_rounds} rounds a step)")

    profile_train(tres["trainer"], tres["spare"][:4])
    timings = probe_timings + time_kernels(res["svc"], res["requests"], args.seed)
    timings += time_int8_kernels(q8["svc"].table, q8["requests"])
    run_profiled("int8 score", lambda: [q8["svc"].score(d, r) for d, r in q8["requests"][:8]],
                 8, "request")
    del q8
    timings += time_train_kernels(tres["trainer"], tres["spare"][4], args.seed)
    profile_phase(res["svc"], res["requests"], args.seed)

    # the lifecycle path, with the counters set to 0 just before it
    reset_launches()
    t0 = time.perf_counter()
    life = lifecycle_live(args, res["svc"].table, res["assigned"], cuda, card)
    lifecycle_depth(args, cuda, card)
    life_counts = launches()
    log(f"lifecycle: path finished in {time.perf_counter() - t0:.1f} s; launches {life_counts} "
        f"on {card}")
    for name, count in life_counts.items():
        if count <= 0:
            raise AssertionError(f"the lifecycle path never launched {name}")
    timings += time_lifecycle_kernels(life["trainer"], life["policy"], args.seed)

    # the model zoo, with the counters set to 0 just before it
    reset_launches()
    t0 = time.perf_counter()
    zoo_res = zoo(args, res["svc"].table, cuda, card)
    zoo_counts = launches()
    log(f"zoo: path finished in {time.perf_counter() - t0:.1f} s; launches {zoo_counts} "
        f"on {card}")
    for r in zoo_res:
        log(f"zoo summary {r['kind']}: " + ", ".join(f"{k} {v}" for k, v in r.items()
                                                      if k != "kind"))
    for name, count in zoo_counts.items():
        if count <= 0:
            raise AssertionError(f"the zoo path never launched {name}")

    # the embed API, retrieval and table groups, each with the counters set
    # to 0 just before it
    phase_counts = {}
    for name, phase in (("embed", lambda: embed_phase(args, res["svc"].table, cuda, card)),
                        ("retrieval", lambda: retrieval(args, cuda, card)),
                        ("group", lambda: group_phase(args, cuda, card))):
        reset_launches()
        t0 = time.perf_counter()
        out = phase()
        phase_counts[name] = launches()
        log(f"{name}: path finished in {time.perf_counter() - t0:.1f} s; launches "
            f"{phase_counts[name]} on {card}")
        for kname, count in phase_counts[name].items():
            if count <= 0:
                raise AssertionError(f"the {name} path never launched {kname}")
    run_profiled("group", lambda: [out["trainer"].train_step(b) for b in out["spare"][:2]], 2,
                 "step")
    timings += time_group_kernels(out["trainer"], out["spare"][2], args.seed)
    group_p50 = out["steps"]["p50_ms"]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    timings += time_col_kernels(args, args.seed)
    phase_counts["colsharded"] = col["launches"]

    # the sharded table groups on a world of one, with the counters set to 0
    # just before them
    reset_launches()
    t0 = time.perf_counter()
    group_sharded_phase(args, group_p50, cuda, card)
    phase_counts["group_sharded"] = launches()
    log(f"group_sharded: path finished in {time.perf_counter() - t0:.1f} s; launches "
        f"{phase_counts['group_sharded']} on {card}")
    for kname, count in phase_counts["group_sharded"].items():
        if count <= 0:
            raise AssertionError(f"the group_sharded path never launched {kname}")

    # one HTTP front over two rank processes, with the parent holding no
    # table; each rank sets its counters to 0 just before its main path
    http_single = res["http_single"]
    del res, tres, life, zoo_res
    gc.collect()
    torch.cuda.empty_cache()
    front = sharded_http_phase(args, http_single, cuda, card)
    phase_counts["sharded_http"] = front["launches"]
    for kname in ("row_gather", "row_scatter_set"):  # requests; the restores and reload
        if front["launches"][kname] <= 0:
            raise AssertionError(f"the sharded_http path never launched {kname}")

    # the entry points of entry.py, the counters set to 0 just before the forward
    reset_launches()
    phase_counts["entry"] = entry_phase(args, cuda, card)

    # the measurement harnesses, each with the counters set to 0 just before it
    t0 = time.perf_counter()
    phase_counts["harness"] = harness_phase(args, cuda, card)
    log(f"harness: phase finished in {time.perf_counter() - t0:.1f} s; launches "
        f"{phase_counts['harness']} on {card}")

    # the DMA probe's kernels and harnesses, every counter set to 0 just
    # before its harnesses (after the checks)
    t0 = time.perf_counter()
    dma_res = dma_phase(args, cuda, card)
    dma_counts = dma_res["counts"]
    dma_timings = time_dma_kernels(dma_res)
    log(f"dma: phase finished in {time.perf_counter() - t0:.1f} s")
    meta = {
        "row_gather": ("meepoembedding_tpu_torch/csrc/row_gather.cu",
                       "meepoembedding_tpu/table/pallas_ops.py:58"),
        "row_scatter_set": ("meepoembedding_tpu_torch/csrc/row_scatter_set.cu",
                            "meepoembedding_tpu/table/pallas_ops.py:200 + "
                            "meepoembedding_tpu/table/stream_merge.py:224"),
        "row_scatter_add": ("meepoembedding_tpu_torch/csrc/row_scatter_add.cu",
                            "meepoembedding_tpu/table/pallas_ops.py:187"),
        "row_merge_add": ("meepoembedding_tpu_torch/csrc/row_merge_add.cu",
                          "meepoembedding_tpu/table/stream_merge.py:61"),
        "bucket_probe": ("meepoembedding_tpu_torch/csrc/bucket_probe.cu",
                         "none: meepoembedding_tpu/table/xla_ops.py:59 `probe` is XLA code"),
    }
    keys = ("label", "shape", "ms", "device_ms", "kernel_ms", "plain_ms", "bound_ms",
            "sector_bound_ms", "library_ms", "max_abs_err", "host_us", "resolved_share")
    kernels = []
    for name, (source, replaces) in meta.items():
        mine = [t for n, t in timings if n == name]
        e = mine[0]  # the first shape listed is the kernel's main one
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train_counts[name], "launches_serve": serve_counts[name],
            "launches_lifecycle": life_counts[name], "launches_zoo": zoo_counts[name],
            "launches_int8": int8_counts[name], "launches_sharded": sharded_counts[name],
            "launches_cli": cli_counts[name],
            **{f"launches_{p}": c[name] for p, c in phase_counts.items()},
            "launches_dma": dma_counts[name],
            "max_abs_err": max(t["max_abs_err"] for t in mine), "ms": e["ms"],
            "device_ms": e["device_ms"], "kernel_ms": e["kernel_ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"], "bound_by": "bytes",
            "library_ms": e["library_ms"], "shape": e["shape"],
            "shapes": [{k: t[k] for k in keys if k in t} for t in mine],
        })
    # K6 and K7: nothing launched them before the dma phase (their counters,
    # never set to 0 before it, read 0 there), so each earlier phase's count is 0
    earlier = ("train", "serve", "lifecycle", "zoo", "int8", "sharded", "cli", *phase_counts)
    for name, replaces in (("row_block_gather", "bench_dma.py:76"),
                           ("row_block_scatter", "bench_dma.py:137")):
        mine = dma_timings[name]
        e = mine[0]  # R = 1, W = 32
        kernels.append({
            "name": name, "route": "cuda",
            "source": "meepoembedding_tpu_torch/csrc/row_block_copy.cu", "replaces": replaces,
            "launches": dma_counts[name],
            **{f"launches_{p}": dma_res["earlier"][name] for p in earlier},
            "launches_dma": dma_counts[name],
            "max_abs_err": max(t["max_abs_err"] for t in mine), "ms": e["ms"],
            "device_ms": e["device_ms"], "kernel_ms": e["kernel_ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"], "bound_by": "bytes",
            "library_ms": e["library_ms"], "host_us": e["host_us"], "shape": e["shape"],
            "shapes": [{k: t[k] for k in keys if k in t} for t in mine],
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
