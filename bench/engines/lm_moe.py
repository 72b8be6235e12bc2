"""The LM engine over a mixture-of-experts decoder:
``MemoryAugmentedEngine(cfg, params, ServeConfig(**serve))`` with the
port's model config ``port`` (its family ``moe``, checked against the
configuration file's published sizes) and weights the benchmark draws on
the card from the seed (``reference.lm.draw``), bound into the port's
modules. Documents and prompts are token arrays on the host.

The check (``reference.check.compare_lm``): the reference's float32
forward over one ingest call drawn from the seed, against the stored
rows (the embedding gaps), F's bookkeeping, and the HNSW link's sampled
runs over the port's rows. The control stands the reference's forward
with its products in float8 in for those rows. A dense LM is another
kind, with a module of its own."""
from __future__ import annotations

import contextlib

from bench import generator
from bench.engines import embedding

# the embedding gaps' limits are the configuration's (``check_limits``)
LIMITS = {"state": 0, "graph": 0}


def lm_dims(model: dict) -> dict:
    """The sizes the reference's forward needs, from an LM configuration
    file's published keys (as run)."""
    d, heads = model["hidden_size"], model["num_attention_heads"]
    e = model["num_local_experts"]
    pad_e = e if e <= 16 or e % 16 == 0 else ((e + 15) // 16) * 16
    v = model["vocab_size"]
    return {"num_layers": model["num_hidden_layers"], "d_model": d,
            "num_heads": heads, "num_kv_heads": model["num_key_value_heads"],
            "head_dim": d // heads, "expert_d_ff": model["intermediate_size"],
            "num_experts": e, "padded_experts": pad_e,
            "top_k": model["num_experts_per_tok"], "vocab_size": v,
            "padded_vocab": ((v + 255) // 256) * 256,
            "rope_theta": float(model["rope_theta"]),
            "rms_eps": float(model["rms_norm_eps"])}


def _port_model(config: dict):
    """The port's ModelConfig, checked against the file's sizes."""
    from repro_torch import configs
    cfg = configs.get_config(config["port"])
    dims = lm_dims(config)
    port = {"num_layers": cfg.num_layers, "d_model": cfg.d_model,
            "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim_, "expert_d_ff": cfg.expert_d_ff,
            "num_experts": cfg.num_experts,
            "padded_experts": cfg.padded_experts,
            "top_k": cfg.num_experts_per_tok, "vocab_size": cfg.vocab_size,
            "padded_vocab": cfg.padded_vocab,
            "rope_theta": float(cfg.rope_theta), "rms_eps": cfg.rms_eps}
    if port != dims or cfg.family != "moe" or not cfg.tie_embeddings:
        raise ValueError(f"the port's {cfg.name} is not the file's model: "
                         f"{port} against {dims}")
    return cfg, dims


def weight_seed(seed: int) -> int:
    return generator.derive_seed(seed, "weights", 0)


def _bind(params, weights: dict) -> None:
    """Make the drawn tensors the port's parameters."""
    import torch
    leaf = {"ln_attn": ("ln_attn", "scale"), "ln_ffn": ("ln_ffn", "scale"),
            "wq": ("attn", "wq"), "wk": ("attn", "wk"), "wv": ("attn", "wv"),
            "wo": ("attn", "wo"), "router": ("moe", "router"),
            "w_gate": ("moe", "w_gate"), "w_up": ("moe", "w_up"),
            "w_down": ("moe", "w_down")}

    def put(module, attr, t):
        old = module._parameters[attr]
        if tuple(old.shape) != tuple(t.shape) or old.dtype != t.dtype:
            raise ValueError(f"{attr}: {tuple(t.shape)} {t.dtype} against "
                             f"{tuple(old.shape)} {old.dtype}")
        module._parameters[attr] = torch.nn.Parameter(t, requires_grad=False)

    for name, t in weights.items():
        if name == "embed":
            put(params, "embed", t)
        elif name == "final_norm":
            put(params.final_norm, "scale", t)
        else:
            _, i, rest = name.split(".", 2)
            sub, attr = leaf[rest]
            put(getattr(params.blocks[int(i)], sub), attr, t)


class System(embedding.System):
    kind = "lm_moe"

    def __init__(self, config: dict, device, seed: int = 0):
        from bench.reference import lm
        from repro_torch.models import transformer
        from repro_torch.serve.engine import MemoryAugmentedEngine
        cfg, self.dims = _port_model(config)
        self.d_model = cfg.d_model
        params = transformer.init_params(cfg, None)
        _bind(params, lm.draw(self.dims, weight_seed(seed), device))
        self.engine = MemoryAugmentedEngine(
            cfg, params, embedding.serve_config(config["serve"]),
            device=device)

    def prepare(self, x):
        """Token documents come from the client's host."""
        return x.cpu().numpy()

    def facts(self, mix: dict) -> dict:
        from bench import roofline
        out = super().facts(mix)
        out["flops_per_doc"] = roofline.lm_flops_per_doc(
            self.dims, int(mix["data"]["length"]))
        return out


def build(config: dict, device, seed: int):
    return System(config, device, seed)


def check(out) -> tuple:
    """The reference's forward over one ingest call's documents, drawn
    from the seed among the window's calls (the whole batch: the MoE's
    capacity couples a batch's documents)."""
    import torch
    from bench.reference import boundary, check as ref, lm
    wl, state = out.workload, out.state
    calls = [i for i, (s, _, _) in enumerate(wl.docs) if s == "ingest"] \
        or [len(wl.docs) - 1]
    pick = calls[generator.derive_seed(out.seed, "check.embed", 0)
                 % len(calls)]
    start = sum(n for _, _, n in wl.docs[:pick])
    stream, index, n = wl.docs[pick]
    dims = lm_dims(out.cell.config)
    weights = lm.draw(dims, weight_seed(out.seed), out.device)
    tokens = out.gen.batch(stream, index, n)
    emb = lm.pooled(weights, tokens, dims).cpu().numpy()
    control_rows = None
    if out.control:
        control_rows = boundary.normalize(
            lm.pooled(weights, tokens, dims, quantize=True).cpu().numpy(),
            state["contract"])
    del weights
    if torch.device(out.device).type == "cuda":
        torch.cuda.empty_cache()
    out.rows = state["vectors"]
    checks, work = ref.compare_lm(
        emb, range(start, start + n), sum(n for _, _, n in wl.docs),
        wl.acked, state, wl.first, wl.sampled_run(),
        control_rows=control_rows)
    work["embed_call"] = pick
    return checks, work


def control():
    """The control is the reference's float8 forward, which ``check``
    stands in for the stored rows; the program runs as it is."""
    return contextlib.nullcontext()
