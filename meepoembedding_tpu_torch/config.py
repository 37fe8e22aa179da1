"""Config dataclasses: a verbatim copy of `meepoembedding_tpu/config.py`.

The port keeps its own copy so that it never imports the JAX package (whose
`__init__` pulls in jax). The two must stay field-for-field identical: the
parity tests build both packages from the same values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

LANES = 128  # TPU vector lane width; one hash bucket == one lane row.


def _pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Sparse optimizer applied in-place to table rows (SURVEY.md C4).

    kind: one of "sgd", "momentum", "rowwise_adagrad", "adagrad", "adam",
    "ftrl".
    Rowwise variants keep ONE scalar of state per row (the standard trick for
    huge embedding tables); full variants keep per-element state planes.
    FTRL-Proximal (the classic CTR sparse optimizer) keeps z (linear) and n
    (squared-grad) planes; l1 > 0 drives untouched-signal weights to exact 0.
    """

    kind: str = "rowwise_adagrad"
    learning_rate: float = 0.05
    eps: float = 1e-8
    beta1: float = 0.9  # adam
    beta2: float = 0.999  # adam
    initial_accumulator: float = 0.1  # adagrad family
    l1: float = 0.0  # ftrl L1 strength
    l2: float = 0.0  # ftrl L2 strength
    ftrl_beta: float = 1.0  # ftrl denominator smoothing

    def num_rowwise_slots(self) -> int:
        return {"sgd": 0, "momentum": 0, "rowwise_adagrad": 1, "adagrad": 0,
                "adam": 0, "ftrl": 0}[self.kind]

    def num_fulldim_slots(self) -> int:
        return {"sgd": 0, "momentum": 1, "rowwise_adagrad": 0, "adagrad": 1,
                "adam": 2, "ftrl": 2}[self.kind]


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Admission / eviction policy (SURVEY.md C10; README.md:2 "dynamic").

    - admit_threshold: insert a new id only once it has been seen this many
      times (frequency admission, counted by an on-device count-min sketch).
      1 means always admit.
    - evict_policy: "none" | "lfu" | "ttl" | "lfu_ttl".
    - ttl_steps: evict rows not touched for this many steps (ttl modes).
    - lfu_min_freq: evict rows whose hit count is below this (lfu modes).
    - max_evict_per_pass: static upper bound of rows exported per evict pass.
    - cms_width: count-min sketch width (lanes) per hash row; 4 hash rows.
    """

    admit_threshold: int = 1
    evict_policy: str = "none"
    ttl_steps: int = 1 << 30
    lfu_min_freq: int = 0
    max_evict_per_pass: int = 1 << 14
    cms_width: int = 1 << 15
    # Buckets scanned per evict pass (rotating window; None = whole table).
    # At 2^27 capacity the full-plane candidate scan measured ~1.2 s on a
    # v5e; a 2^13-bucket window visits the whole table every nb/K ticks at
    # ~K/nb of that cost. Trainers rotate the cursor automatically.
    evict_scan_buckets: Optional[int] = None

    def __post_init__(self):
        assert self.cms_width % LANES == 0, "cms_width must be a multiple of 128"

    @property
    def needs_scores(self) -> bool:
        """freq/last maintenance is only paid when some policy consumes it."""
        return self.evict_policy != "none" or self.admit_threshold > 1


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """Static geometry + behavior of one logical dynamic table (SURVEY.md C11).

    - dim: embedding dimension. Either a divisor of 128 (rows are packed,
      128//dim per storage row: zero HBM tile padding) or a multiple of 128.
    - capacity: total number of rows across all shards; rounded up so each
      shard holds a power-of-two number of 128-slot buckets.
    - initializer_scale: fresh-row magnitude, derived *statelessly* from
      the key hash (deterministic regardless of insert order — this is what
      makes elastic restore bit-stable). 0.0 means zero-init.
    - initializer: "uniform" (-s, s) | "normal" (sigma=s) |
      "truncated_normal" (sigma=s, exact +-2 sigma) | "constant" (== s).
    - max_probe_rounds: linear-probing chain length before a key is dropped.
    """

    dim: int = 32
    capacity: int = 1 << 20
    initializer_scale: float = 0.01
    initializer: str = "uniform"
    max_probe_rounds: int = 4
    # Bound on ADMITTED inserts per lookup batch (admission throttling).
    # Pending keys beyond the cap are deferred to their next occurrence
    # (counted as drops). None = unbounded. A small cap (e.g. 1<<15) keeps
    # steps with a few misses from paying batch-sized insert planning.
    insert_cap: Optional[int] = None
    # Online growth (SURVEY.md C11 "handles growth/rehash"): when the live
    # row count would exceed this load fraction, the single-device table
    # DOUBLES capacity and rehashes every live row (with full optimizer/score
    # state) into the new geometry BEFORE admitting the batch — a mis-sized
    # initial capacity never becomes a permanent drop. None = fixed capacity.
    grow_at_load: Optional[float] = None
    value_dtype: str = "float32"
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    policy: PolicyConfig = dataclasses.field(default_factory=PolicyConfig)
    name: str = "table"

    def __post_init__(self):
        d = self.dim
        assert (d <= LANES and LANES % d == 0) or (d % LANES == 0), (
            f"dim={d} must divide 128 or be a multiple of 128"
        )

    def buckets_per_shard(self, num_shards: int) -> int:
        """Number of 128-slot buckets per shard (power of two, >= 1)."""
        per_shard_rows = -(-self.capacity // num_shards)
        nb = 1
        while nb * LANES < per_shard_rows:
            nb *= 2
        return nb


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """DLRM/CTR model geometry (SURVEY.md C16)."""

    kind: str = "dlrm"  # dlrm | ctr_mlp | dcn | deepfm | two_tower | din | bst
    num_dense_features: int = 13
    num_sparse_features: int = 26
    # two_tower only: the first num_query_features sparse columns feed the
    # query tower, the rest the item tower (models/two_tower.py).
    num_query_features: int = 1
    # two_tower only: sampling-bias-corrected in-batch softmax — subtract a
    # streaming log q(item) estimate from negative logits (ops/itemfreq.py).
    logq_correction: bool = False
    embedding_dim: int = 32
    # Bag combiner for multi-hot features (ids shaped [B, S, L], padded with
    # the invalid sentinel): "sum" | "mean" | "sqrtn". Ignored for one-hot
    # [B, S] id batches. See ops/pooling.py.
    combiner: str = "mean"
    bottom_mlp: Tuple[int, ...] = (128, 64, 32)
    top_mlp: Tuple[int, ...] = (256, 128, 1)
    num_cross_layers: int = 3  # dcn only
    attention_mlp: Tuple[int, ...] = (32,)  # din activation-unit hidden sizes
    # bst only (models/bst.py): encoder geometry over [target + behaviors]
    attention_heads: int = 2
    transformer_blocks: int = 1
    max_seq_len: int = 64  # upper bound on bag_len + 1 (position table rows)
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One training/benchmark run (SURVEY.md C21)."""

    batch_size: int = 4096
    unique_cap: Optional[int] = None  # static dedup capacity; None -> batch*hot
    steps: int = 100
    seed: int = 0
    log_every: int = 20
    eval_every: int = 0
    dense_learning_rate: float = 1e-3
    # Dense-tower LR schedule over run.steps (ops/optim.py schedule_lr):
    # "constant" | "linear" | "cosine", with an optional linear warmup.
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    # Global-norm clip on the dense-tower grads (after the DP psum, so the
    # decision is device-identical). None = off; 0.0 freezes the towers
    # (embedding-only fine-tune). Sparse/table grads are NOT clipped — the
    # adaptive sparse optimizers self-normalize per row.
    grad_clip_norm: Optional[float] = None
    mesh_shape: Tuple[int, ...] = ()  # () -> all devices on one 'shard' axis
    profile_dir: Optional[str] = None
    # Static per-(src,dst) all-to-all capacity = a2a_factor * unique_cap / S.
    # Owner routing is a murmur-mixed hash, so per-destination counts are
    # binomial(U, 1/S): 1.25x the mean is already tens of sigma of headroom.
    # The sharded trainer COUNTS any overflow (route_drops) and auto-doubles
    # the factor (recompiling the step) if a drop is ever observed, so the
    # exchange is drop-free in steady state without lossless S-times buffers.
    a2a_factor: float = 1.25
    # Ragged ID/row/grad exchange (parallel/ragged.py): the payload rides
    # lax.ragged_all_to_all so ICI carries only the rows that actually
    # routed (<= U per direction) instead of the dense factor*U padding;
    # route drops move from per-(src,dst) overflow to total-receiver
    # overflow (tighter concentration). Dense remains the default: XLA:CPU
    # has no ragged-all-to-all lowering, so CPU meshes run the same plan
    # over an element-exact emulated transport (tests cover it; production
    # CPU deployments should stay dense).
    a2a_ragged: bool = False
    # Host-fetch lag of the sharded trainer (parallel/trainer.py): step i's
    # scalars/arrays are read back only at step i+depth, so the host never
    # blocks on the step it just dispatched and the device pipeline stays
    # full — the discipline bench.py proved necessary for honest throughput.
    # 0 = fully synchronous per-step semantics (exact per-step loss returns).
    pipeline_depth: int = 2
