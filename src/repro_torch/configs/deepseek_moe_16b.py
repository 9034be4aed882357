"""deepseek-moe-16b — 2 shared + 64 routed top-6 fine-grained MoE
[arXiv:2401.06066]. Layer 0 uses a dense FFN (d_ff 10944), layers 1..27
use the MoE FFN, as in the original model."""

import dataclasses

from repro_torch.models.moe import MoEConfig

from .base import LayerDesc, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,  # MHA
        head_dim=128,
        d_ff=1408,  # per routed expert
        vocab_size=102400,
        rope_theta=10000.0,
        tie_embeddings=False,
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                      num_shared=2),
        dense_first_layer=True,
        dense_first_d_ff=10944,
        pattern=(LayerDesc(kind="attn", attn_type="global", ff="moe"),),
        source="arXiv:2401.06066",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=32, vocab_size=512, dense_first_d_ff=128,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, num_shared=2),
    )
