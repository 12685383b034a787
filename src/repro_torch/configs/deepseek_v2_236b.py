"""DeepSeek-V2 236B — MLA (kv_lora=512) + MoE (2 shared + 160 routed, top-6).

[arXiv:2405.04434] 60L d_model=5120 128H d_ff(expert)=1536 vocab=102400.
Layer 0 stays dense (d_ff=12288) per the HF config. MLA absorbed decode
caches 576 B/token-equivalent (c_kv 512 + k_pe 64).
Full attention => long_500k skipped. Requires FSDPxTP (see DESIGN §6).
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,  # MLA: all heads share the compressed KV
        d_ff=1536,
        vocab_size=102400,
        attn_kind="mla",
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=1536,
            qk_nope_dim=128,
            qk_rope_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=160,
            top_k=6,
            num_shared=2,
            expert_d_ff=1536,
            first_k_dense=1,
            dense_d_ff=12288,
            capacity_factor=1.25,
        ),
        mlp_kind="swiglu",
        skip_shapes=("long_500k",),
        skip_reason="pure full attention (MLA is a cache compression, "
        "not sub-quadratic attention)",
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="deepseek-v2-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=512,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(
            num_experts=8, top_k=2, num_shared=1, expert_d_ff=96,
            first_k_dense=1, dense_d_ff=128, capacity_factor=1.5,
        ),
        loss_chunk=0,
    )
