"""Mamba-2 SSD (state-space duality) layer, the chunked formulation.

The port's copy of ``src/repro/models/ssm.py``: the selective state-space
model of arXiv:2405.21060 by the chunked SSD algorithm. Within a chunk
the terms are attention-like batched matmuls; across chunks a short
sequential scan carries the per-chunk state. ``ssd_reference`` is the
naive O(S) scan the tests hold it against, and ``ssm_decode_step``
carries the O(1) recurrent state for decoding.

Parameterization as mamba2's: per-head scalar decay A, grouped B/C of
state dim N (broadcast over heads by repeating each group, as
``jnp.repeat`` does), a depthwise short conv on (x, B, C), and a gated
RMSNorm before the output projection. The projections and the conv run
in the compute dtype, dt and the scan in f32.

As in the reference, the prefill clips dt to [dt_min, 100·dt_max] and
the decode step does not, so the two differ wherever the softplus falls
below dt_min.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import rmsnorm_apply, rmsnorm_specs
from .params import ParamSpec
from .sharding_utils import constrain, einsum, unshard_fsdp, viewable

__all__ = ["SSMConfig", "ssd_chunked", "ssd_reference", "ssm_apply",
           "ssm_cache_shape", "ssm_decode_step", "ssm_specs"]


class SSMConfig(NamedTuple):
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def ssm_specs(cfg: SSMConfig, dtype) -> Dict[str, Any]:
    d, di, n, g, h = (cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_groups,
                      cfg.n_heads)

    def w(shape, logical):
        return ParamSpec(shape, logical, dtype=dtype, init="scaled",
                         fan_in_axes=(0,))

    return {
        "wz": w((d, di), ("fsdp", "ssm_inner")),
        "wx": w((d, di), ("fsdp", "ssm_inner")),
        "wB": w((d, g * n), ("fsdp", None)),
        "wC": w((d, g * n), ("fsdp", None)),
        "wdt": w((d, h), ("fsdp", None)),
        "conv_x": w((cfg.d_conv, di), ("conv", "ssm_inner")),
        "conv_B": w((cfg.d_conv, g * n), ("conv", None)),
        "conv_C": w((cfg.d_conv, g * n), ("conv", None)),
        "dt_bias": ParamSpec((h,), (None,), dtype=torch.float32,
                             init="constant", scale=0.0),
        "A_log": ParamSpec((h,), (None,), dtype=torch.float32, init="zeros"),
        "D": ParamSpec((h,), (None,), dtype=torch.float32, init="ones"),
        "norm": rmsnorm_specs(di, torch.float32),
        "wo": w((di, d), ("ssm_inner", "fsdp")),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x [B, S, C], kernel [W, C]; tap after tap
    in x's dtype."""
    w, s = kernel.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, w - 1, 0))
    out = torch.zeros_like(x)
    for i in range(w):
        out = out + xp[:, i:i + s, :] * kernel[i][None, None, :]
    return out


# each input projection's output axis (its fsdp dim is gathered at use)
_PROJ = (("wz", "ssm_inner"), ("wx", "ssm_inner"), ("wB", None),
         ("wC", None), ("wdt", None))


def _project(params, u: torch.Tensor, cfg: SSMConfig):
    dtype = u.dtype
    return tuple(torch.matmul(u, unshard_fsdp(params[name], "fsdp",
                                              out).to(dtype))
                 for name, out in _PROJ)


def _heads(t: torch.Tensor, cfg: SSMConfig, groups: bool) -> torch.Tensor:
    """[..., H·P] -> [..., H, P], or [..., G·N] -> [..., H, N] with each
    group repeated over its H/G heads (``jnp.repeat``, not tile); on a
    mesh whose split of the last dim does not divide H (or G) it is
    gathered first (``sharding_utils.viewable``)."""
    if not groups:
        t = viewable(t, -1, cfg.n_heads)
        return t.reshape(t.shape[:-1] + (cfg.n_heads, cfg.head_dim))
    t = viewable(t, -1, cfg.n_groups)
    g = t.reshape(t.shape[:-1] + (cfg.n_groups, cfg.d_state))
    return g.repeat_interleave(cfg.n_heads // cfg.n_groups, dim=-2)


def _activate(params, x, bb, cc, dt, cfg: SSMConfig):
    x, bb, cc = F.silu(x), F.silu(bb), F.silu(cc)
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    dt = torch.clamp(dt, cfg.dt_min, cfg.dt_max * 100.0)
    a = -torch.exp(params["A_log"].float())  # [H], negative
    # pin (batch, heads) so that the chunked SSD's einsums stay local
    return (constrain(_heads(x, cfg, False), "batch", None, "ssm_inner",
                      None),
            constrain(_heads(bb, cfg, True), "batch", None, "ssm_inner",
                      None),
            constrain(_heads(cc, cfg, True), "batch", None, "ssm_inner",
                      None),
            constrain(dt, "batch", None, "ssm_inner"), a)


def ssd_chunked(xh: torch.Tensor, bh: torch.Tensor, ch: torch.Tensor,
                dt: torch.Tensor, a: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, f32 throughout. xh [B,S,H,P], bh/ch [B,S,H,N],
    dt [B,S,H], a [H] (negative) -> (y [B,S,H,P], h_final [B,H,N,P])."""
    b, s, h, p = xh.shape
    n = bh.shape[-1]
    assert s % chunk == 0, (s, chunk)
    nc, q = s // chunk, chunk

    def rs(t):  # [B,S,...] -> [B,nc,chunk,...] in f32
        return t.float().reshape((b, nc, q) + t.shape[2:])

    xc, bc, cc, dtc = rs(xh), rs(bh), rs(ch), rs(dt)
    da = dtc * a[None, None, None, :]  # [B,nc,Q,H]
    cum = torch.cumsum(da, dim=2)  # inclusive within the chunk
    total = cum[:, :, -1, :]  # [B,nc,H]

    # ---- intra-chunk (attention-like): L[i,j] = exp(cum_i - cum_j), i >= j
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Q,Q,H]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=xh.device))
    # masked before the exp: above the diagonal cum_i - cum_j > 0 can
    # overflow, and exp's backward would multiply its zero gradient by inf
    # (the reference exps first: the same values, NaN gradients there)
    decay = torch.exp(torch.where(mask[None, None, :, :, None], li,
                                  -torch.inf))
    scores = einsum("bnihd,bnjhd->bnijh", cc, bc)  # C_i . B_j
    att = scores * decay * dtc[:, :, None, :, :]  # weighted by dt_j
    y_intra = einsum("bnijh,bnjhp->bnihp", att, xc)

    # ---- chunk states: sum_j exp(total - cum_j) dt_j B_j (x) x_j
    w = torch.exp(total[:, :, None, :] - cum) * dtc  # [B,nc,Q,H]
    states = einsum("bnjhd,bnjhp->bnhdp", w[..., None] * bc, xc)

    # ---- inter-chunk recurrence over nc, emitting the state that enters
    # each chunk
    chunk_decay = torch.exp(total)  # [B,nc,H]
    hcur = (torch.zeros(b, h, n, p, device=xh.device) if h0 is None
            else h0.float())
    enter = []
    for c in range(nc):
        enter.append(hcur)
        hcur = hcur * chunk_decay[:, c, :, None, None] + states[:, c]
    h_enter = torch.stack(enter, dim=1)  # [B,nc,H,N,P]

    # ---- inter-chunk contribution: C_i . (exp(cum_i) * h_enter)
    y_inter = einsum("bnihd,bnhdp->bnihp",
                           cc * torch.exp(cum)[..., None], h_enter)
    return (y_intra + y_inter).reshape(b, s, h, p), hcur


def ssd_reference(xh, bh, ch, dt, a, h0=None):
    """The naive sequential scan (the tests' oracle)."""
    b, s, h, p = xh.shape
    n = bh.shape[-1]
    hst = (torch.zeros(b, h, n, p, device=xh.device) if h0 is None
           else h0.float())
    ys = []
    for t in range(s):
        dct = torch.exp(dt[:, t, :] * a[None, :])  # [B,H]
        upd = torch.einsum("bh,bhd,bhp->bhdp", dt[:, t, :].float(),
                           bh[:, t].float(), xh[:, t].float())
        hst = hst * dct[:, :, None, None] + upd
        ys.append(torch.einsum("bhd,bhdp->bhp", ch[:, t].float(), hst))
    return torch.stack(ys, dim=1), hst


def _chunk_for(s: int, chunk: int) -> int:
    """``chunk``, or the largest divisor of s below it."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def ssm_apply(params, u: torch.Tensor, cfg: SSMConfig,
              return_cache: bool = False):
    """Full-sequence SSD forward (prefill). u [B, S, d_model] -> out of the
    same shape; with ``return_cache`` also the decode cache: the last
    d_conv - 1 *pre-conv* inputs (zero-padded on the left) and the final
    state in u's dtype."""
    dtype = u.dtype
    b, s = u.shape[:2]
    z, x_pre, bb_pre, cc_pre, dt = _project(params, u, cfg)
    x = _causal_conv(x_pre, params["conv_x"].to(dtype))
    bb = _causal_conv(bb_pre, params["conv_B"].to(dtype))
    cc = _causal_conv(cc_pre, params["conv_C"].to(dtype))
    xh, bh, ch, dtf, a = _activate(params, x, bb, cc, dt, cfg)
    y, hfin = ssd_chunked(xh, bh, ch, dtf, a, _chunk_for(s, cfg.chunk))
    y = y + params["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, cfg.d_inner).to(dtype)
    y = rmsnorm_apply(params["norm"], y * F.silu(z))
    out = torch.matmul(y, unshard_fsdp(params["wo"], "ssm_inner",
                                       "fsdp").to(dtype))
    if not return_cache:
        return out

    def tail(t):
        w = cfg.d_conv - 1
        tp = F.pad(t, (0, 0, w, 0))
        return tp[:, tp.shape[1] - w:, :]

    return out, {"conv_x": tail(x_pre), "conv_B": tail(bb_pre),
                 "conv_C": tail(cc_pre), "h": hfin.to(dtype)}


# ---------------------------------------------------------------------------
# Decode: O(1) recurrent state
# ---------------------------------------------------------------------------

def ssm_cache_shape(cfg: SSMConfig, batch: int) -> Dict[str, tuple]:
    gn = cfg.n_groups * cfg.d_state
    return {
        "conv_x": (batch, cfg.d_conv - 1, cfg.d_inner),
        "conv_B": (batch, cfg.d_conv - 1, gn),
        "conv_C": (batch, cfg.d_conv - 1, gn),
        "h": (batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
    }


def _conv_step(state: torch.Tensor, xnew: torch.Tensor,
               kernel: torch.Tensor):
    """state [B, W-1, C], xnew [B, C] -> (new state, y [B, C])."""
    full = torch.cat([state, xnew[:, None, :]], dim=1)  # [B, W, C]
    return full[:, 1:, :], einsum("bwc,wc->bc", full, kernel)


def ssm_decode_step(params, u: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cfg: SSMConfig
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """u [B, 1, d_model] -> (out [B, 1, d_model], the new cache). The state
    is read as f32 and stored in the cache's dtype; dt is not clipped."""
    dtype = u.dtype
    b = u.shape[0]
    z, x, bb, cc, dt = (t[:, 0] for t in _project(params, u, cfg))

    conv_x, x = _conv_step(cache["conv_x"], x, params["conv_x"].to(dtype))
    conv_B, bb = _conv_step(cache["conv_B"], bb, params["conv_B"].to(dtype))
    conv_C, cc = _conv_step(cache["conv_C"], cc, params["conv_C"].to(dtype))

    x, bb, cc = F.silu(x), F.silu(bb), F.silu(cc)
    dtf = F.softplus(dt.float() + params["dt_bias"][None, :])
    a = -torch.exp(params["A_log"].float())
    xh = _heads(x, cfg, False).float()
    bh, ch = _heads(bb, cfg, True).float(), _heads(cc, cfg, True).float()

    h = cache["h"].float()  # [B,H,N,P]
    decay = torch.exp(dtf * a[None, :])  # [B,H]
    upd = einsum("bh,bhd,bhp->bhdp", dtf, bh, xh)
    h = h * decay[:, :, None, None] + upd
    y = einsum("bhd,bhdp->bhp", ch, h)
    y = y + params["D"].float()[None, :, None] * xh
    y = y.reshape(b, cfg.d_inner).to(dtype)
    y = rmsnorm_apply(params["norm"], y * F.silu(z))
    out = torch.matmul(y, unshard_fsdp(params["wo"], "ssm_inner",
                                       "fsdp").to(dtype))
    return out[:, None, :], {"conv_x": conv_x, "conv_B": conv_B,
                             "conv_C": conv_C, "h": h.to(cache["h"].dtype)}
