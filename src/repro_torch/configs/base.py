"""Architecture, shape-grid and training configuration (the port's own
copy of ``repro/configs/base.py``: plain frozen dataclasses).

Every assigned architecture is expressed as a ``ModelConfig``. The same
dataclass covers dense GQA transformers, MLA (DeepSeek), MoE, RWKV6,
Mamba2 hybrids, and encoder-decoder (Whisper) — family-specific fields are
simply unused elsewhere. The port's models implement every family: the
GQA and MLA LMs (RMSNorm or LayerNorm, SwiGLU or GELU MLP, or a mixture of
experts; full or sliding-window attention; the vision stub), RWKV6, the
Mamba2 hybrid and the encoder-decoder (Whisper). The shape grid
(``ShapeSpec``, ``ALL_SHAPES``) is the reference's, cell for cell.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Shape grid (assigned input shapes — identical for every LM-family arch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    """One (workload kind, seq_len, global_batch) cell of the shape grid."""

    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeSpec("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524288, 1)

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0  # routed experts (0 = dense model)
    top_k: int = 2
    num_shared: int = 0  # always-on shared experts (DeepSeek-V2 style)
    expert_d_ff: int = 0  # per-expert hidden size
    capacity_factor: float = 1.25
    first_k_dense: int = 0  # leading layers that stay dense (DeepSeek-V2)
    dense_d_ff: int = 0  # d_ff for those dense layers
    router_aux_weight: float = 0.01  # load-balance loss weight
    # dispatch impl: "auto" picks ep_a2a/local shard_map paths on a mesh and
    # the pure-GSPMD gather path on CPU; "gather"/"einsum" force baselines
    impl: str = "auto"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / RWKV6 recurrent-family parameters."""

    kind: str = "mamba2"  # "mamba2" | "rwkv6"
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2  # d_inner = expand * d_model (mamba2)
    conv_kernel: int = 4
    chunk_len: int = 256  # chunked-scan length for training


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: SSM backbone + periodic shared attention."""

    attn_every: int = 6  # apply the shared attention block every N layers
    shared_attn: bool = True  # attention params shared across applications


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention flavour
    attn_kind: str = "gqa"  # gqa | mla | none (ssm)
    qk_norm: bool = False  # Qwen3
    rope_theta: float = 10000.0
    sliding_window: int = 0  # >0 -> SWA (Mixtral); masks beyond window
    causal: bool = True
    # mlp flavour
    mlp_kind: str = "swiglu"  # swiglu | gelu
    # norm
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None

    # encoder-decoder (Whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 1500  # frontend-stub frame count
    frontend: str = "none"  # none | audio_stub | vision_stub
    frontend_tokens: int = 0  # stub embedding count prepended (vlm)

    # numerics / perf policy knobs (hillclimbing surface)
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "block"  # none | block | full
    scan_layers: bool = True
    # sequence-parallel activation sharding (set by launch code to the mesh
    # axis sizes; 0 = off). Residual-stream activations between layers are
    # constrained to [B->data, S->model] — required to fit train_4k HBM.
    act_shard_data: int = 0
    act_shard_model: int = 0
    # blockwise-attention tiles: 1024/2048 measured -8.5% memory term vs
    # 512/1024 on qwen3 train_4k (fewer tile-boundary HBM crossings); still
    # VMEM-safe for the Pallas kernel at bf16
    attn_block_q: int = 1024
    attn_block_kv: int = 2048
    loss_chunk: int = 512  # vocab-xent seq chunking (0 = unchunked)
    use_flash_kernel: bool = False  # Pallas path (TPU target only)
    vocab_pad_to: int = 256

    # which grid shapes are valid for this arch (skip rules)
    skip_shapes: Tuple[str, ...] = ()
    skip_reason: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def is_attention_free(self) -> bool:
        return self.attn_kind == "none"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter count (for roofline MODEL_FLOPS = 6 N D) ----
    def param_count(self, active_only: bool = False) -> int:
        d, ff, V = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        per_layer = 0
        # attention (hybrid: the shared attention block is counted once below)
        if self.hybrid is not None:
            pass
        elif self.attn_kind == "gqa":
            per_layer += d * self.n_heads * hd  # Wq
            per_layer += 2 * d * self.n_kv_heads * hd  # Wk, Wv
            per_layer += self.n_heads * hd * d  # Wo
        elif self.attn_kind == "mla":
            m = self.mla
            per_layer += d * m.q_lora_rank
            per_layer += m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
            per_layer += d * (m.kv_lora_rank + m.qk_rope_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        # mlp / moe / ssm
        if self.ssm is not None and self.attn_kind == "none":
            if self.ssm.kind == "rwkv6":
                per_layer += 5 * d * d  # r,k,v,g,out (time mix)
                per_layer += d * self.d_ff + self.d_ff * d + d * d  # channel mix
            else:
                dinner = self.ssm.expand * d
                per_layer += d * 2 * dinner + dinner * d  # in/out proj (x, z)
        elif self.hybrid is not None:
            # mamba backbone layers only; the SHARED attention+MLP block is
            # one parameter set counted once below
            s = self.ssm
            dinner = s.expand * d
            H = dinner // s.head_dim
            per_layer += d * (2 * dinner + 2 * s.d_state + H) + dinner * d
        else:
            n_mlp = 3 if self.mlp_kind == "swiglu" else 2
            if self.moe is not None and self.moe.num_experts > 0:
                moe_ff = self.moe.expert_d_ff
                per_layer_moe = (
                    (self.moe.num_experts + self.moe.num_shared) * n_mlp * d * moe_ff
                )
                per_layer += per_layer_moe
            else:
                per_layer += n_mlp * d * ff

        total = self.n_layers * per_layer + 2 * V * d  # embed + unembed
        if self.hybrid is not None:
            # one shared attention+MLP block (Zamba2)
            n_mlp = 3 if self.mlp_kind == "swiglu" else 2
            total += 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            total += n_mlp * d * ff
        if self.enc_dec:
            total += self.n_enc_layers * (4 * d * self.n_heads * hd + 2 * d * ff)
        if not active_only or self.moe is None or self.moe.num_experts == 0:
            return total
        # active params: only top_k + shared experts per token
        moe_ff = self.moe.expert_d_ff
        n_mlp = 3 if self.mlp_kind == "swiglu" else 2
        full_moe = self.n_layers * (self.moe.num_experts + self.moe.num_shared) * n_mlp * d * moe_ff
        active_moe = self.n_layers * (self.moe.top_k + self.moe.num_shared) * n_mlp * d * moe_ff
        return total - full_moe + active_moe

    def valid_shapes(self) -> Tuple[ShapeSpec, ...]:
        return tuple(s for s in ALL_SHAPES if s.name not in self.skip_shapes)


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop level knobs (optimizer, FL/local-update schedule)."""

    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    opt_state_dtype: str = "float32"  # "bfloat16" for the huge archs
    microbatches: int = 1  # gradient accumulation (activation-memory lever)
    # local-update / federated outer loop
    inner_steps: int = 1  # H; 1 => fully synchronous DP
    outer_optimizer: str = "nesterov"  # FedAvg server optimizer
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    compression: str = "none"  # none | topk | int8
    topk_ratio: float = 0.01
