"""A plain float32 forward of the port's mixture-of-experts decoder stack,
for the pooled document embeddings of the LM cells. Plain PyTorch: no
kernel, no cache, no batching across documents beyond what the MoE's
capacity needs, and every matrix product in float32 with TF32 off.

It follows the port's model semantics (``ModelConfig``, family ``moe``)
as written down here, not the port's code:

* embeddings: the token's row of the table (tied to the head, which the
  pooled embedding does not use);
* each of ``num_layers`` blocks: h += attn(rmsnorm(h)); h += moe(rmsnorm(h));
  rmsnorm is x / sqrt(mean(x^2) + eps) * (1 + w);
* attention: GQA (``num_kv_heads`` key/value heads, query head j reading
  key/value head j // G), rotate-half RoPE on the first and second halves
  of each head at theta ``rope_theta``, logits scaled by 1/sqrt(head_dim),
  causal softmax;
* MoE: float32 router logits over the padded expert count (padding experts
  at -1e30), softmax, the top ``k`` by a stable descending sort,
  renormalised; each expert keeps its first ``capacity`` (token, rank)
  pairs in token order, capacity = max(8, ceil8(T * k * 1.25 / E)) over the
  batch's T tokens, and the pairs beyond it are dropped; an expert is
  down(silu(x gate) * (x up));
* the embedding: the last hidden state (before the final norm), averaged
  over positions.

Departures from the published granite-3.0-3b-a800m-base: no
``embedding_multiplier``, ``attention_multiplier``, ``residual_multiplier``
or ``logits_scaling``; RMSNorm in the (1 + w) form; an expert capacity with
dropping, where the published model routes every token; the router over a
padded expert count. Those are the port's semantics, which the benchmark
measures.

``quantize`` is the control: the same forward with every matrix product's
operands rounded to float8 (e4m3, one scale per tensor), the precision
step below the port's bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

NEG = -1e30


def capacity(tokens: int, k: int, experts: int, factor: float = 1.25) -> int:
    c = int(tokens * k * factor / experts)
    return max(8, ((c + 7) // 8) * 8)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one per-tensor scale, back to float32."""
    amax = x.abs().max().clamp(min=1e-30)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def _mm(a, b, quantize: bool):
    if quantize:
        a, b = _fp8(a), _fp8(b)
    return a @ b


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x, pos, theta):
    d2 = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, 2 * d2, 2, dtype=torch.float32,
                                          device=x.device) / (2 * d2)))
    ang = pos.to(torch.float32)[:, None] * freqs[None, :]       # [L, d2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(w: Dict[str, torch.Tensor], x, dims: dict, quantize: bool,
               chunk: int):
    B, L, D = x.shape
    H, KV, Dh = dims["num_heads"], dims["num_kv_heads"], dims["head_dim"]
    G = H // KV
    pos = torch.arange(L, device=x.device)
    causal = pos[None, :] <= pos[:, None]
    out = torch.empty_like(x)
    for b0 in range(0, B, chunk):
        xb = x[b0:b0 + chunk]
        n = xb.shape[0]
        flat = xb.reshape(n * L, D)
        q = _mm(flat, w["wq"].reshape(D, H * Dh), quantize).view(n, L, H, Dh)
        k = _mm(flat, w["wk"].reshape(D, KV * Dh), quantize).view(n, L, KV, Dh)
        v = _mm(flat, w["wv"].reshape(D, KV * Dh), quantize).view(n, L, KV, Dh)
        q, k = _rope(q, pos, dims["rope_theta"]), _rope(k, pos,
                                                        dims["rope_theta"])
        kk = k.repeat_interleave(G, dim=2)
        vv = v.repeat_interleave(G, dim=2)
        qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, kk, vv))
        logits = _mm(qh, kh.transpose(-1, -2), quantize) / math.sqrt(Dh)
        logits = logits.masked_fill(~causal, NEG)
        p = torch.softmax(logits, dim=-1)
        ctx = _mm(p, vh, quantize).permute(0, 2, 1, 3).reshape(n * L, H * Dh)
        out[b0:b0 + chunk] = _mm(ctx, w["wo"].reshape(H * Dh, D),
                                 quantize).view(n, L, D)
    return out


def _moe(w: Dict[str, torch.Tensor], x, dims: dict, quantize: bool):
    B, L, D = x.shape
    T = B * L
    E_pad, E, K = dims["padded_experts"], dims["num_experts"], dims["top_k"]
    xt = x.reshape(T, D)
    logits = xt @ w["router"]          # the router stays float32
    logits[:, E:] = NEG
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    C = capacity(T, K, E)
    pair_e = top_e.reshape(-1)
    pair_w = top_p.reshape(-1)
    pair_tok = torch.arange(T, device=x.device).repeat_interleave(K)
    y = torch.zeros_like(xt)
    for e in range(E):
        sel = torch.nonzero(pair_e == e).reshape(-1)[:C]   # token order
        if sel.numel() == 0:
            continue
        tok = pair_tok[sel]
        h = xt[tok]
        g = _mm(h, w["w_gate"][e], quantize)
        u = _mm(h, w["w_up"][e], quantize)
        o = _mm(F.silu(g) * u, w["w_down"][e], quantize)
        y.index_add_(0, tok, o * pair_w[sel][:, None])
    return y.view(B, L, D)


@torch.no_grad()
def pooled(weights: Dict[str, torch.Tensor], tokens: torch.Tensor,
           dims: dict, quantize: bool = False, chunk: int = 64
           ) -> torch.Tensor:
    """tokens [B, L] -> float32 [B, D]: the mean over positions of the last
    hidden state. ``weights`` maps the names of ``param_shapes`` to
    float32 tensors on the device the forward runs on."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        h = weights["embed"][tokens.long()].to(torch.float32)
        eps = dims["rms_eps"]
        for i in range(dims["num_layers"]):
            w = {k.split(".", 2)[2]: v for k, v in weights.items()
                 if k.startswith(f"blocks.{i}.")}
            h = h + _attention(w, _rms(h, w["ln_attn"], eps), dims, quantize,
                               chunk)
            h = h + _moe(w, _rms(h, w["ln_ffn"], eps), dims, quantize)
        return h.mean(dim=1)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def param_shapes(dims: dict) -> Dict[str, tuple]:
    """Name -> shape of every weight the forward reads, in draw order."""
    D, H, KV, Dh = (dims["d_model"], dims["num_heads"], dims["num_kv_heads"],
                    dims["head_dim"])
    E, Fe = dims["padded_experts"], dims["expert_d_ff"]
    out = {"embed": (dims["padded_vocab"], D)}
    for i in range(dims["num_layers"]):
        p = f"blocks.{i}."
        out.update({p + "ln_attn": (D,), p + "ln_ffn": (D,),
                    p + "wq": (D, H, Dh), p + "wk": (D, KV, Dh),
                    p + "wv": (D, KV, Dh), p + "wo": (H, Dh, D),
                    p + "router": (D, E), p + "w_gate": (E, D, Fe),
                    p + "w_up": (E, D, Fe), p + "w_down": (E, Fe, D)})
    out["final_norm"] = (D,)
    return out


def fan_in(name: str, shape: tuple) -> Optional[int]:
    """The scale of a drawn weight: 1/sqrt(fan-in) for the projections,
    1 for the embedding table, 0.1 for the norms' zero-centred scales."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("embed",):
        return 1
    if leaf in ("ln_attn", "ln_ffn", "final_norm"):
        return None
    if leaf == "wo":
        return shape[0] * shape[1]
    if leaf in ("w_gate", "w_up", "w_down"):
        return shape[1]
    return shape[0]


def draw(dims: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight, float32, from one normal draw over one flat buffer on
    ``device`` (the tensors are views of it), scaled per leaf."""
    shapes = param_shapes(dims)
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=g)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        fi = fan_in(name, shape)
        t.mul_(0.1 if fi is None else 1.0 / math.sqrt(fi))
        out[name] = t
        off += n
    return out
