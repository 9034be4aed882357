"""llama3-405b — dense GQA transformer, 128k vocab [arXiv:2407.21783]."""

import dataclasses

from .base import LayerDesc, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        family="dense",
        num_layers=126,
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab_size=128256,
        rope_theta=500000.0,
        tie_embeddings=False,
        pattern=(LayerDesc(kind="attn", attn_type="global", ff="dense"),),
        source="arXiv:2407.21783",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
    )
