"""Configuration dataclasses for the PyTorch port of SALS.

A copy of the reference's ``repro/config/base.py``: :class:`ModelConfig`,
:class:`SALSConfig`, the mesh layout :class:`MeshConfig`, the grid cells
:class:`ShapeConfig` / :data:`SHAPES`, :class:`ServeConfig` and
:class:`TrainConfig`.  The port keeps its own copy so that it never imports
the JAX package; the field names, defaults and validation are the
reference's, so a config built here describes the same model there.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Tuple

FAMILIES = ("dense", "moe", "hybrid", "ssm", "encoder", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description for one model.

    ``family`` selects the block structure:
      dense   — attention + gated MLP          (llama/qwen/granite/gemma/yi)
      moe     — attention + mixture-of-experts (llama4-scout, qwen3-moe)
      hybrid  — parallel attention ‖ SSM heads (hymba)
      ssm     — attention-free RWKV6 blocks    (rwkv6)
      encoder — bidirectional attention        (hubert; training only)
      vlm     — dense LM + vision-prefix stub  (paligemma)
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True
    causal: bool = True
    attn_logit_softcap: float = 0.0

    mlp_act: str = "swiglu"  # swiglu | geglu

    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    moe_capacity_factor: float = 1.25

    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_conv: int = 4
    rwkv_head_size: int = 64

    tie_embeddings: bool = True
    frontend: str = "none"
    vision_patches: int = 256

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        """Stacked multi-head key width — the SALS projection operates here."""
        return self.n_kv_heads * self.head_dim

    @property
    def group_size(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def is_decoder(self) -> bool:
        return self.family != "encoder"

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d = self.d_model
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        if self.family == "ssm":  # rwkv6: time-mix + channel-mix
            per_layer = 4 * d * d + d * self.d_ff * 2 + 6 * d  # approx
        else:
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.family == "moe":
                ff_in = 3 * self.d_model * self.expert_d_ff
                mlp = self.n_experts * ff_in \
                    + self.n_shared_experts * 3 * d * self.d_ff
                mlp += d * self.n_experts  # router
            else:
                mlp = 3 * d * self.d_ff
            if self.family == "hybrid":
                ssm_d = self.ssm_heads * self.head_dim
                mlp += 2 * d * ssm_d + ssm_d * d \
                    + ssm_d * (2 * self.ssm_state + 2)
            per_layer = attn + mlp
        return emb + head + self.n_layers * per_layer

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        act_mlp = (self.experts_per_token + self.n_shared_experts) * 3 * d \
            * self.expert_d_ff
        act_mlp += d * self.n_experts
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return emb + head + self.n_layers * (attn + act_mlp)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU tests (the reference's sizes
        and family branches)."""
        small = dict(
            n_layers=min(self.n_layers, 3),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            name=self.name + "-smoke",
        )
        if self.family == "moe":
            # high capacity factor: drop-free routing at the reduced sizes
            small.update(n_experts=4,
                         experts_per_token=min(2, self.experts_per_token),
                         moe_d_ff=128, moe_capacity_factor=8.0)
        if self.family == "hybrid":
            small.update(ssm_heads=2, ssm_state=8)
        if self.family == "ssm":
            small.update(rwkv_head_size=16)
        if self.family == "vlm":
            small.update(vision_patches=16)
        small.update(overrides)
        return replace(self, **small)


@dataclass(frozen=True)
class SALSConfig:
    """Sparse Attention in Latent Space settings (paper §4, §5.1).

    ``rank_ratio``  r = rank_ratio · kv_dim; ``score_ratio`` r* = score_ratio
    · r; ``n_critical`` top-k budget; ``n_sink`` / ``n_recent`` always-kept
    prefix / suffix; ``v_bits`` value-cache bits (8 or 4, group ``v_group``);
    ``k_latent_dtype`` "bfloat16" or "int8" (per-token scale).
    """

    enabled: bool = True
    rank_ratio: float = 0.25
    score_ratio: float = 0.5
    n_critical: int = 432
    n_sink: int = 16
    n_recent: int = 64
    v_bits: int = 8
    v_group: int = 64
    k_latent_dtype: str = "bfloat16"
    skip_layers_front: int = 2
    skip_layers_back: int = 1

    def rank(self, kv_dim: int) -> int:
        r = int(round(self.rank_ratio * kv_dim))
        return max(8, min(kv_dim, _round_to(r, 8)))

    def score_rank(self, kv_dim: int) -> int:
        r = self.rank(kv_dim)
        return max(8, _round_to(int(round(self.score_ratio * r)), 8))

    def n_selected(self, seq_len: int) -> int:
        """Total tokens attended per decode step."""
        return min(seq_len, self.n_sink + self.n_critical + self.n_recent)

    def sals_layer_mask(self, n_layers: int):
        """Per-layer bool list — True where SALS sparsification is active."""
        return [not (i < self.skip_layers_front
                     or i >= n_layers - self.skip_layers_back)
                for i in range(n_layers)]


def _round_to(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


SALS_25 = SALSConfig(rank_ratio=0.25, v_bits=8, n_critical=432)
SALS_125 = SALSConfig(rank_ratio=0.125, v_bits=4, n_critical=432)


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh + sharding strategy.

    ``dist_mode`` for SALS decode:
      "global" — paper-faithful: one global top-N_c over the whole cache
      "local"  — one top-N_c/G per kv_seq shard + an LSE merge
    """

    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")
    dist_mode: str = "local"
    seq_parallel: bool = True          # shard residual stream on model axis

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a != "model")

    @property
    def model_axis(self) -> str:
        return "model"


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the grid."""

    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatches: int = 1  # grad-accumulation splits for train cells


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 300
    batch_size: int = 8
    seq_len: int = 256
    lr: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    microbatches: int = 1
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    log_every: int = 10
    seed: int = 0
    grad_compression: str = "none"   # none | int8_ef
    ckpt_dir: str = "artifacts/ckpt"


@dataclass(frozen=True)
class ServeConfig:
    """Serving settings, field for field the reference's ``ServeConfig``.

    Validated as in the reference, so one config describes the same
    deployment in both packages.
    """

    max_seq_len: int = 4096
    max_batch: int = 8
    max_new_tokens: int = 64
    temperature: float = 0.0
    sals: SALSConfig = field(default_factory=SALSConfig)
    seed: int = 0
    pad_id: int = 0
    scheduler: str = "continuous"
    prefill_chunk: int = 32
    prefill_token_budget: int = 256
    page_size: int = 0
    n_pages: int = 0
    prefix_cache: bool = True
    hbm_pages: int = 0
    tier_prefetch: bool = True
    prefix_cache_entries: int = 4
    prefix_share_pages: int = 8
    max_queue: int = 0
    queue_policy: str = "reject"
    request_timeout_steps: int = 0
    request_timeout_ms: float = 0.0
    max_request_retries: int = 2
    retry_backoff_steps: int = 1
    retry_backoff_cap_steps: int = 16
    audit_every: int = 0
    priority_classes: int = 1
    preempt_policy: str = "park"
    tenant_quantum: int = 256
    tenant_rate: float = 0.0
    tenant_max_inflight: int = 0
    gauge_history: int = 0
    spec_window: int = 0

    def __post_init__(self):
        if self.max_queue < 0:
            raise ValueError("max_queue must be >= 0 (0 = unbounded)")
        if self.queue_policy not in ("reject", "shed-oldest"):
            raise ValueError(f"unknown queue_policy {self.queue_policy!r}")
        if self.request_timeout_steps < 0 or self.audit_every < 0:
            raise ValueError("request_timeout_steps / audit_every >= 0")
        if self.request_timeout_ms < 0:
            raise ValueError("request_timeout_ms must be >= 0 (0 = none)")
        if self.spec_window < 0 or self.spec_window > 8:
            raise ValueError("spec_window must be in [0, 8]")
        if self.spec_window > 1:
            if self.sals.enabled and self.spec_window > self.sals.n_recent:
                raise ValueError(
                    f"spec_window {self.spec_window} > sals.n_recent "
                    f"{self.sals.n_recent}")
            if self.hbm_pages:
                raise ValueError("speculative decoding needs the untiered "
                                 "cache")
            if self.temperature > 0.0:
                raise ValueError("speculative decoding is greedy-only")
        if (self.max_request_retries < 0 or self.retry_backoff_steps < 0
                or self.retry_backoff_cap_steps < 0):
            raise ValueError("retry knobs must be >= 0")
        if self.page_size < 0 or self.n_pages < 0:
            raise ValueError("page_size / n_pages must be >= 0")
        if self.hbm_pages < 0:
            raise ValueError("hbm_pages must be >= 0 (0 = untiered)")
        if self.priority_classes < 1:
            raise ValueError("priority_classes must be >= 1")
        if self.preempt_policy not in ("park", "evict", "none"):
            raise ValueError(f"unknown preempt_policy {self.preempt_policy!r}")
        if self.tenant_quantum < 1:
            raise ValueError("tenant_quantum must be >= 1")
        if self.tenant_rate < 0 or self.tenant_max_inflight < 0:
            raise ValueError("tenant_rate / tenant_max_inflight >= 0")
        if self.gauge_history < 0:
            raise ValueError("gauge_history must be >= 0 (0 = unbounded)")
        if (self.priority_classes > 1 and self.preempt_policy == "park"
                and self.page_size == 0):
            raise ValueError("preempt_policy 'park' needs the paged latent "
                             "cache (page_size > 0)")
        if self.page_size == 0:
            if self.hbm_pages:
                raise ValueError("hbm_pages needs the paged latent cache "
                                 "(set page_size > 0)")
            return
        if self.max_seq_len % self.page_size:
            raise ValueError(f"max_seq_len {self.max_seq_len} must be a "
                             f"multiple of page_size {self.page_size}")
        if self.page_size % self.prefill_chunk:
            raise ValueError(f"page_size {self.page_size} must be a multiple "
                             f"of prefill_chunk {self.prefill_chunk}")
        if self.scheduler != "continuous":
            raise ValueError("the paged latent cache requires the "
                             "continuous scheduler")
        if self.n_pages and self.n_pages * self.page_size < self.max_seq_len:
            raise ValueError(f"n_pages {self.n_pages} × page_size "
                             f"{self.page_size} cannot hold one max_seq_len "
                             f"{self.max_seq_len} sequence")
        if self.hbm_pages:
            if self.hbm_pages < self.max_batch + 1:
                raise ValueError(f"hbm_pages {self.hbm_pages} must be >= "
                                 f"max_batch + 1 = {self.max_batch + 1}")
            if self.hbm_pages > self.pool_pages:
                raise ValueError(f"hbm_pages {self.hbm_pages} exceeds the "
                                 f"pool capacity {self.pool_pages}")

    @property
    def pool_pages(self) -> int:
        """Effective pool size (auto = dense-equivalent capacity)."""
        if not self.page_size:
            return 0
        return self.n_pages or (self.max_batch * self.max_seq_len
                                // self.page_size)


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)
