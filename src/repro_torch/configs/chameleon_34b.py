"""chameleon-34b — early-fusion VLM backbone [arXiv:2405.09818].

Early fusion means VQ image tokens share the 65536-entry vocabulary with
text tokens, so the backbone consumes plain token ids; the image tokenizer
frontend is a stub per the assignment.
"""

import dataclasses

from .base import LayerDesc, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        num_layers=48,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=65536,
        rope_theta=10000.0,
        tie_embeddings=False,
        pattern=(LayerDesc(kind="attn", attn_type="global", ff="dense"),),
        source="arXiv:2405.09818",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
    )
