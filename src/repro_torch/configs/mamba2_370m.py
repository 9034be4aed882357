"""mamba2-370m — attention-free SSD stack [arXiv:2405.21060]."""

import dataclasses

from repro_torch.models.ssm import SSMConfig

from .base import LayerDesc, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        tie_embeddings=True,
        ssm=SSMConfig(d_model=1024, d_state=128, d_conv=4, expand=2,
                      head_dim=64, n_groups=1, chunk=256),
        pattern=(LayerDesc(kind="mamba", ff="none"),),
        source="arXiv:2405.21060",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=4, d_model=64, vocab_size=512,
        ssm=SSMConfig(d_model=64, d_state=16, d_conv=4, expand=2,
                      head_dim=16, n_groups=1, chunk=16),
    )
