"""Configuration schema for the Nightjar reproduction framework (a copy of
the reference's): every architecture is a :class:`ModelConfig`, the four
assigned input shapes are :class:`ShapeConfig`, and the mesh / sharding
policy is :class:`ParallelConfig`.  Configs are frozen dataclasses, so
they hash and can key caches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description covering all assigned families."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention details -------------------------------------------------
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen2
    rope_theta: float = 10_000.0
    pos_embedding: str = "rope"    # rope | learned | none
    logit_softcap: float = 0.0
    max_position_embeddings: int = 1_048_576

    # --- mlp / norms --------------------------------------------------------
    mlp_type: str = "swiglu"       # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    rmsnorm_offset: bool = False   # gemma's (1 + scale) convention
    embed_scale: bool = False      # gemma multiplies embeddings by sqrt(d)
    tie_embeddings: bool = True

    # --- mixture of experts --------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_groups: int = 1   # hierarchical dispatch groups (== batch shards)

    # --- state space (mamba2 / SSD) ------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # --- hybrid (zamba2) ------------------------------------------------------
    hybrid_attn_every: int = 0     # apply shared attention block every N layers

    # --- encoder-decoder (whisper) ---------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0
    cross_attention: bool = False
    enc_context: int = 1500        # whisper 30s window (decoder cross-KV length)

    # --- vlm (paligemma) ---------------------------------------------------------
    num_image_tokens: int = 0      # bidirectional prefix length

    # --- numerics / compilation ---------------------------------------------------
    dtype: str = "bfloat16"
    scan_layers: bool = True       # stack layer params & lax.scan over layers
    unroll_scans: bool = False     # unroll inner scans (exact HLO flop counts)
    remat: str = "none"            # none | full | dots
    attn_chunk: int = 1024         # kv-chunk for blockwise prefill attention
    xent_chunk: int = 512          # sequence chunk for streamed cross entropy

    # -------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid families)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --- layers of two kinds (port only: fields of :class:`WindowedConfig`) --
    # Here class attributes, not fields, so that a config of the reference's
    # architectures holds exactly the reference's fields: every layer
    # attends over its whole context with one rope.
    layer_types = ()
    sliding_window = 0
    yarn_factor = 0.0

    def layer_window(self, i: int) -> int:
        """The window of layer ``i``: the positions up to and including its
        own that a query sees (0: all of them)."""
        if self.layer_types and self.layer_types[i] == SLIDING:
            return self.sliding_window
        return 0


FULL, SLIDING = "full_attention", "sliding_attention"


@dataclass(frozen=True)
class WindowedConfig(ModelConfig):
    """A decoder whose layers are of two kinds (``layer_types``): full
    attention, and sliding-window attention over the last
    ``sliding_window`` positions, the query's own included (query p sees
    keys p - W + 1 .. p).  The full layers' rope may be yarn's
    (``yarn_factor`` > 0; the sliding layers keep the plain rope of
    ``rope_theta``): inverse frequencies blended between the plain ones and
    those divided by the factor over the band that ``yarn_beta_fast`` /
    ``yarn_beta_slow`` rotations within ``yarn_original_max`` positions
    mark, and cos and sin scaled by ``yarn_attention_factor``."""

    layer_types: Tuple[str, ...] = ()
    sliding_window: int = 0
    yarn_factor: float = 0.0
    yarn_original_max: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_attention_factor: float = 1.0

    def __post_init__(self):
        if self.layer_types:
            if len(self.layer_types) != self.num_layers:
                raise ValueError(f"{self.name}: {len(self.layer_types)} "
                                 f"layer types for {self.num_layers} layers")
            bad = set(self.layer_types) - {FULL, SLIDING}
            if bad:
                raise ValueError(f"{self.name}: unknown layer types {bad}")
            if SLIDING in self.layer_types and self.sliding_window < 1:
                raise ValueError(f"{self.name}: sliding layers need a "
                                 f"sliding_window of at least 1")


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def replace(self, **kw) -> "ShapeConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh & sharding policy: the reference's record, kept as data (its
    tests compare the two).  Nothing in the port reads it: the dry run
    picks the weight mode in ``launch.dryrun._weight_mode`` and hands it to
    ``distributed.sharding.param_specs``; ``cache_specs`` always shards the
    cache's sequence over ``model``; and ``explicit_decode_collectives``
    names a module neither package has (ROADMAP C12)."""

    multi_pod: bool = False
    # logical axis assignment
    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: str = "pod"
    # weight sharding: "tp"   -> weights replicated over data, sharded over model
    #                  "fsdp" -> weights 2D-sharded over (data, model)
    weight_mode: str = "fsdp"
    # KV-cache sequence dim sharded over the model axis (context parallelism)
    context_parallel: bool = True
    # explicit decode collectives instead of automatic sharding propagation
    # (named by the reference; no module of either package implements it)
    explicit_decode_collectives: bool = False

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)


# The four assigned shapes ----------------------------------------------------
TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """Assigned shapes applicable to an architecture: long_500k only for
    the sub-quadratic (ssm / hybrid) families."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.is_subquadratic:
        out.append(LONG_500K)
    return tuple(out)
