"""The model configurations: one :class:`ModelConfig` for every family.

The port's copy of ``src/repro/configs/base.py``. A dense, MoE, hybrid
(attention + Mamba), pure-SSM or encoder-decoder model is one config whose
layer heterogeneity (gemma2's local/global alternation, jamba's 1:7
attention:Mamba interleave with MoE every other layer, deepseek's dense
first layer) is a *block pattern*: a tuple of :class:`LayerDesc` cycled
over depth. The port serves every family but the encoder-decoder
(``repro_torch.models.model.model_specs`` refuses it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig

__all__ = ["SHAPES", "LayerDesc", "ModelConfig", "MoEConfig", "SSMConfig",
           "ShapeSpec", "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    kind: str = "attn"  # 'attn' | 'mamba'
    attn_type: str = "global"  # 'global' | 'local'
    ff: str = "dense"  # 'dense' | 'moe' | 'none'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec-audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # attention
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    local_window: int = 4096
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_scale: Optional[float] = None
    attn_chunk_q: int = 512
    attn_dense_threshold: int = 2048
    # ff / moe
    act: str = "silu"
    moe: Optional[MoEConfig] = None
    # hybrid / ssm
    ssm: Optional[SSMConfig] = None
    # block pattern (cycled); overrides simple defaults when set
    pattern: Tuple[LayerDesc, ...] = (LayerDesc(),)
    dense_first_layer: bool = False  # deepseek-moe: layer 0 uses dense FF
    dense_first_d_ff: int = 0
    # encoder-decoder (audio stub frontend provides frame embeddings)
    is_encdec: bool = False
    encoder_layers: int = 0
    encoder_frames: int = 1024  # stub frame count for shape specs
    # embeddings
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma: x *= sqrt(d_model)
    # norms
    norm_eps: float = 1e-6
    post_norm: bool = False  # gemma2: additional post-sublayer norms
    # dtypes / execution
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    scan_layers: bool = True
    remat_policy: str = "nothing_saveable"  # nothing_saveable|dots|none
    # sequence parallelism: the residual stream sharded over the model
    # axis; refused on one card (repro_torch.models.transformer)
    sequence_parallel: bool = False
    # ring-buffer KV for local-attention layers: cache capacity =
    # window instead of seq
    local_ring_cache: bool = False
    # provenance
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        body = self.num_layers - (1 if self.dense_first_layer else 0)
        if body % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: {body} body layers not divisible by "
                f"pattern period {len(self.pattern)}"
            )

    @property
    def num_blocks(self) -> int:
        body = self.num_layers - (1 if self.dense_first_layer else 0)
        return body // len(self.pattern)

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def attention_free(self) -> bool:
        return all(d.kind != "attn" for d in self.pattern)

    @property
    def pure_full_attention(self) -> bool:
        """True when every layer is global full attention (no SSM/local)."""
        return all(
            d.kind == "attn" and d.attn_type == "global"
            for d in self.pattern
        )

    @property
    def supports_long_context(self) -> bool:
        """long_500k eligibility: sub-quadratic / bounded-window stacks."""
        return not self.pure_full_attention

    def param_count(self) -> int:
        from repro_torch.models import model as _model
        from repro_torch.models.params import param_count

        return param_count(_model.model_specs(self))

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k of num_experts of every
        leaf on the 'experts' axis, truncated leaf by leaf as the
        reference truncates)."""
        from repro_torch.models import model as _model
        from repro_torch.models.params import param_count, spec_leaves

        specs = _model.model_specs(self)
        if self.moe is None:
            return param_count(specs)
        active_frac = self.moe.top_k / self.moe.num_experts
        return sum(int(s.size * active_frac) if "experts" in s.logical
                   else s.size for _, s in spec_leaves(specs))


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set; the same 4 for every LM arch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(applicable, reason-if-not). Encodes the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention architecture: 500k decode "
                       "requires sub-quadratic attention (skip per "
                       "assignment; see DESIGN.md)")
    return True, ""
