"""Mamba2 SSD (state-space duality) block: chunked matmul form and the
one-token decode recurrence (the port of ``repro.models.layers.ssm``).

Within a chunk the outputs are the quadratic, attention-like form through
a decay-masked product; across chunks the state is carried by a loop over
the chunks (the reference scans them). A sequence longer than a chunk and
not a multiple of it is padded with dt = 0, an exact identity step. The
SSD arithmetic is float32 throughout. Groups broadcast to heads with
``repeat_interleave`` (head i reads group i // (heads / groups)), as
``jnp.repeat`` does.

Decode keeps, per layer, the SSM state [B, H, P, N] in float32 and the
conv tail: the last ``ssm_conv - 1`` rows of the projection's x|B|C part
*before* the causal conv and its SiLU, in the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.initializers import dense_init, device_of
from repro_torch.models.layers.norms import rmsnorm_scale

SSMCache = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #


class Mamba(nn.Module):
    """``in_proj`` [D, 2 Din + 2 G N + H], ``conv_w`` [k, Din + 2 G N],
    ``conv_b``, ``A_log`` (A = -exp(A_log) = -1 at init), ``D_skip``
    (ones), ``dt_bias``, ``norm_scale`` [Din] and ``out_proj`` [Din, D]:
    the reference's ``init_mamba``."""

    def __init__(self, generator: torch.Generator, cfg: ModelConfig):
        super().__init__()
        D = cfg.d_model
        Din, N, G, H = (cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups,
                        cfg.ssm_nheads)
        conv_dim = Din + 2 * G * N
        pd, dev = cfg.params_dtype, device_of(generator)

        def zeros(n):
            return nn.Parameter(torch.zeros(n, dtype=pd, device=dev))

        self.in_proj = nn.Parameter(dense_init(
            generator, (D, 2 * Din + 2 * G * N + H), pd, fan_in=D))
        self.conv_w = nn.Parameter(dense_init(
            generator, (cfg.ssm_conv, conv_dim), pd, fan_in=cfg.ssm_conv))
        self.conv_b = zeros(conv_dim)
        self.A_log = zeros(H)
        self.D_skip = nn.Parameter(torch.ones(H, dtype=pd, device=dev))
        self.dt_bias = zeros(H)
        self.norm_scale = zeros(Din)
        self.out_proj = nn.Parameter(dense_init(generator, (Din, D), pd,
                                                fan_in=Din))


# --------------------------------------------------------------------------- #
# SSD core
# --------------------------------------------------------------------------- #


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., cs] → [..., cs, cs] with out[i, j] = sum_{k=j+1..i} x_k
    (i >= j), -inf above the diagonal: a cumsum difference."""
    cs = x.shape[-1]
    csum = torch.cumsum(x, dim=-1)
    diff = csum[..., :, None] - csum[..., None, :]
    i = torch.arange(cs, device=x.device)
    return torch.where(i[:, None] >= i[None, :], diff, float("-inf"))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int, init_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan. x [b, l, h, p]; dt [b, l, h] (after the softplus); A
    [h] (negative); B, C [b, l, g, n] with h % g == 0. Returns (y [b, l, h,
    p], the final state [b, h, p, n]), both float32."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    cs = min(chunk, l)
    pad = (-l) % cs
    if pad:
        # dt = 0 padding is an exact identity step: decay exp(0 A) = 1 and
        # input dt B x = 0, so the state and the real outputs are unchanged
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    l_pad = l + pad
    nc = l_pad // cs

    f32 = torch.float32
    x, dt = x.to(f32), dt.to(f32)
    Bh = B.to(f32).repeat_interleave(rep, dim=2)  # [b, l, h, n]
    Ch = C.to(f32).repeat_interleave(rep, dim=2)

    xb = x * dt[..., None]                        # input-scaled x
    dA = dt * A.to(f32)[None, None, :]            # [b, l, h] log-decay

    xc = xb.reshape(b, nc, cs, h, p)
    Bc = Bh.reshape(b, nc, cs, h, n)
    Cc = Ch.reshape(b, nc, cs, h, n)
    dAc = dA.reshape(b, nc, cs, h)

    dA_cum = torch.cumsum(dAc, dim=2)             # [b, nc, cs, h]
    dA_total = dA_cum[:, :, -1]                   # [b, nc, h]

    # ---- intra-chunk (quadratic, attention-like form) ------------------ #
    Lmat = torch.exp(_segsum(dAc.movedim(3, 2)))  # [b, nc, h, cs, cs]
    scores = torch.einsum("bzihn,bzjhn->bzhij", Cc, Bc)
    y_diag = torch.einsum("bzhij,bzjhp->bzihp", scores * Lmat, xc)

    # ---- chunk boundary states ----------------------------------------- #
    decay_to_end = torch.exp(dA_total[:, :, None, :] - dA_cum)
    chunk_states = torch.einsum("bzchn,bzch,bzchp->bzhpn", Bc, decay_to_end,
                                xc)

    # ---- inter-chunk recurrence ---------------------------------------- #
    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device) \
        if init_state is None else init_state.to(f32)
    prev = []                                     # the state entering chunk z
    for z in range(nc):
        prev.append(state)
        state = state * torch.exp(dA_total[:, z])[:, :, None, None] \
            + chunk_states[:, z]
    prev_states = torch.stack(prev, dim=1)        # [b, nc, h, p, n]

    # ---- inter-chunk contribution to the outputs ----------------------- #
    y_off = torch.einsum("bzchn,bzhpn,bzch->bzchp", Cc, prev_states,
                         torch.exp(dA_cum))
    y = (y_diag + y_off).reshape(b, l_pad, h, p)[:, :l]
    return y, state


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. state [b, h, p, n]; x [b, h, p]; dt [b, h];
    B, C [b, g, n]. Returns (y [b, h, p], the new state)."""
    h = x.shape[1]
    rep = h // B.shape[1]
    f32 = torch.float32
    Bh = B.to(f32).repeat_interleave(rep, dim=1)  # [b, h, n]
    Ch = C.to(f32).repeat_interleave(rep, dim=1)
    dA = torch.exp(dt.to(f32) * A.to(f32)[None, :])  # [b, h]
    xb = x.to(f32) * dt.to(f32)[..., None]
    new_state = state * dA[:, :, None, None] \
        + torch.einsum("bhp,bhn->bhpn", xb, Bh)
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y, new_state


# --------------------------------------------------------------------------- #
# the Mamba2 block
# --------------------------------------------------------------------------- #


def init_ssm_cache(batch: int, cfg: ModelConfig, device) -> SSMCache:
    """One layer's decode state: ``ssm`` [B, H, P, N] float32 and ``conv``
    [B, ssm_conv - 1, Din + 2 G N] in the compute dtype, zero."""
    Din, N, G, H, P = (cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups,
                       cfg.ssm_nheads, cfg.ssm_headdim)
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, Din + 2 * G * N),
                            dtype=cfg.compute_dtype, device=device),
    }


def _split_proj(z_x_bc_dt: torch.Tensor, cfg: ModelConfig):
    Din, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    z = z_x_bc_dt[..., :Din]
    x = z_x_bc_dt[..., Din:2 * Din]
    B = z_x_bc_dt[..., 2 * Din:2 * Din + G * N]
    C = z_x_bc_dt[..., 2 * Din + G * N:2 * Din + 2 * G * N]
    dt = z_x_bc_dt[..., 2 * Din + 2 * G * N:]
    return z, x, B, C, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv as shifted adds in the input dtype. xbc [b, l,
    c]; w [k, c]; tail [b, k - 1, c] continues an earlier call (zeros by
    default)."""
    kw, L = w.shape[0], xbc.shape[1]
    if tail is None:
        tail = torch.zeros((xbc.shape[0], kw - 1, xbc.shape[2]),
                           dtype=xbc.dtype, device=xbc.device)
    padded = torch.cat([tail.to(xbc.dtype), xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(kw):
        out = out + padded[:, i:i + L] * w[i].to(xbc.dtype)
    return out + bias.to(xbc.dtype)


def mamba_block(params: Mamba, h: torch.Tensor, cfg: ModelConfig, *,
                mode: str, cache_slice: Optional[SSMCache] = None
                ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """h [B, L, D] → ([B, L, D], the layer's cache after this call, or None
    in train mode). ``mode`` is train | prefill | decode (L = 1)."""
    B_, L, _ = h.shape
    dtype = h.dtype
    Din, N, G, H, P = (cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups,
                       cfg.ssm_nheads, cfg.ssm_headdim)
    f32 = torch.float32
    proj = h @ params.in_proj.to(dtype)
    z, x, Bs, Cs, dt = _split_proj(proj, cfg)
    xbc = torch.cat([x, Bs, Cs], dim=-1)

    A = -torch.exp(params.A_log.to(f32))
    dt = F.softplus(dt.to(f32) + params.dt_bias.to(f32))
    D_skip = params.D_skip.to(f32)

    new_cache = None
    if mode == "decode":
        if cache_slice is None:
            raise ValueError("decode needs a cache")
        tail = cache_slice["conv"]
        xbc_conv = F.silu(_causal_conv(xbc, params.conv_w, params.conv_b,
                                       tail))
        new_tail = torch.cat([tail, xbc.to(tail.dtype)], dim=1)[:, 1:]
        xc = xbc_conv[..., :Din].reshape(B_, H, P)
        Bc = xbc_conv[..., Din:Din + G * N].reshape(B_, G, N)
        Cc = xbc_conv[..., Din + G * N:].reshape(B_, G, N)
        y, new_state = ssd_decode_step(cache_slice["ssm"], xc, dt[:, 0], A,
                                       Bc, Cc)
        y = y + D_skip[None, :, None] * xc.to(f32)
        y = y.reshape(B_, 1, Din)
        new_cache = {"ssm": new_state, "conv": new_tail}
    else:
        xbc_conv = F.silu(_causal_conv(xbc, params.conv_w, params.conv_b))
        xc = xbc_conv[..., :Din].reshape(B_, L, H, P)
        Bc = xbc_conv[..., Din:Din + G * N].reshape(B_, L, G, N)
        Cc = xbc_conv[..., Din + G * N:].reshape(B_, L, G, N)
        y, final_state = ssd(xc, dt, A, Bc, Cc, cfg.ssm_chunk)
        y = y + D_skip[None, None, :, None] * xc.to(f32)
        y = y.reshape(B_, L, Din)
        if mode == "prefill":
            if cache_slice is None:
                raise ValueError("prefill needs a cache")
            # the conv tail holds the rows before the conv, as decode
            # appends them
            new_cache = {"ssm": final_state,
                         "conv": xbc[:, -(cfg.ssm_conv - 1):].to(
                             cache_slice["conv"].dtype)}

    # gated RMSNorm, then the out projection (the Mamba2 epilogue)
    y = y.to(dtype) * F.silu(z)
    y = rmsnorm_scale(params.norm_scale, y, cfg.rms_eps)
    return y @ params.out_proj.to(dtype), new_cache
