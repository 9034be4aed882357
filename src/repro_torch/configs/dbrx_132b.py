"""dbrx-132b — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base]."""

import dataclasses

from repro_torch.models.moe import MoEConfig

from .base import LayerDesc, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10752,  # per-expert
        vocab_size=100352,
        rope_theta=500000.0,
        tie_embeddings=False,
        moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
        pattern=(LayerDesc(kind="attn", attn_type="global", ff="moe"),),
        source="hf:databricks/dbrx-base",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=64, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64),
    )
