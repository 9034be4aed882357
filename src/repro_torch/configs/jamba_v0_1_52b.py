"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 with MoE [arXiv:2403.19887].

Block pattern (period 8, matching attn_layer_period=8 / offset=4 and
expert_layer_period=2 / offset=1 of the released model): mamba at indices
{0,2,3,5,6,7}, attention at index 4, MoE FFN at odd indices, dense FFN at
even indices. The Mamba layers use the SSD formulation (TPU-native
adaptation of the paper's Mamba-1 kernels, DESIGN.md §7) with d_state=16.
"""

import dataclasses

from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig

from .base import LayerDesc, ModelConfig


def _pattern():
    descs = []
    for i in range(8):
        kind = "attn" if i == 4 else "mamba"
        ff = "moe" if i % 2 == 1 else "dense"
        descs.append(LayerDesc(kind=kind, attn_type="global", ff=ff))
    return tuple(descs)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        rope_theta=10000.0,
        tie_embeddings=False,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
        ssm=SSMConfig(d_model=4096, d_state=16, d_conv=4, expand=2,
                      head_dim=64, n_groups=1, chunk=256),
        pattern=_pattern(),
        source="arXiv:2403.19887",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
        ssm=SSMConfig(d_model=64, d_state=16, d_conv=4, expand=2,
                      head_dim=16, n_groups=1, chunk=16),
    )
