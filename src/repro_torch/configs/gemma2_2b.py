"""gemma2-2b — local/global alternating attention, logit softcaps
[arXiv:2408.00118]."""

import dataclasses

from .base import LayerDesc, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        rope_theta=10000.0,
        local_window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        query_scale=256.0 ** -0.5,
        act="gelu",
        tie_embeddings=True,
        embed_scale=True,
        post_norm=True,
        pattern=(
            LayerDesc(kind="attn", attn_type="local", ff="dense"),
            LayerDesc(kind="attn", attn_type="global", ff="dense"),
        ),
        source="arXiv:2408.00118",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, local_window=8,
        query_scale=16.0 ** -0.5,
    )
