"""minitron-8b — width-pruned nemotron dense GQA [arXiv:2407.14679]."""

import dataclasses

from .base import LayerDesc, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=256000,
        rope_theta=500000.0,
        tie_embeddings=False,
        act="silu",
        pattern=(LayerDesc(kind="attn", attn_type="global", ff="dense"),),
        source="arXiv:2407.14679",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
    )
