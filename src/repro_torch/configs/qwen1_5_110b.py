"""qwen1.5-110b — dense GQA with QKV bias [hf:Qwen/Qwen1.5 family]."""

import dataclasses

from .base import LayerDesc, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=49152,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1000000.0,
        tie_embeddings=False,
        pattern=(LayerDesc(kind="attn", attn_type="global", ff="dense"),),
        source="hf:Qwen/Qwen1.5-0.5B (scaled per assignment)",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
    )
