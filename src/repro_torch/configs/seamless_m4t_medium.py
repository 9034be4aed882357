"""seamless-m4t-medium — enc-dec multimodal backbone [arXiv:2308.11596].

Modality frontend is a STUB per the assignment: the encoder consumes
precomputed audio frame embeddings [B, frames, d_model] supplied by
``input_specs()``; the decoder is a causal text decoder with cross
attention. RoPE replaces the original sinusoidal positions (TPU-native
adaptation, noted in DESIGN.md §7).
"""

import dataclasses

from .base import LayerDesc, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="encdec-audio",
        num_layers=12,           # decoder layers
        encoder_layers=12,
        is_encdec=True,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256206,
        rope_theta=10000.0,
        act="gelu",
        tie_embeddings=True,
        encoder_frames=1024,
        pattern=(LayerDesc(kind="attn", attn_type="global", ff="dense"),),
        source="arXiv:2308.11596",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        encoder_frames=16,
    )
