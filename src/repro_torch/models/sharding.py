"""Parameter and activation partition rules (the port of
``repro.models.sharding``): FSDP over ``data``, TP over ``model``.

Divisibility-aware: each rule proposes shardings in priority order and the
first whose dimension divides the mesh axis wins; otherwise the dimension
is replicated. One engine covers every arch (MQA kv=1, gemma2's 8 heads,
granite-moe's 40 experts, mamba's packed projections — each falls back
gracefully).

A spec is a tuple with one entry per dimension: an axis name, a tuple of
axis names, or None (replicated), equal to the reference's
``PartitionSpec`` for the same parameter path and shape. Specs are given
in the reference's layout (``models.convert``): stacked leaves carry
leading layer axes, which replicate. The ``pod`` axis is pure DP:
parameters are replicated across pods (the cross-pod traffic is one
gradient all-reduce per step, ``optim.compress``). The rules read only a
mesh's ``axis_names`` and ``shape`` (``launch.mesh.Mesh``);
``models.placement`` places tensors by them over a mesh's devices.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

from repro_torch.launch.mesh import Mesh, batch_axes
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer

Spec = Tuple[Any, ...]


def _div(n: int, mesh: Mesh, axis: str) -> bool:
    return axis in mesh.axis_names and n % mesh.shape[axis] == 0 and n > 0


class Rules:
    def __init__(self, mesh: Mesh, cfg: ModelConfig):
        self.mesh = mesh
        self.cfg = cfg

    def m(self, dim: int) -> Optional[str]:
        """TP-shard a dim over ``model`` if divisible."""
        return "model" if _div(dim, self.mesh, "model") else None

    def d(self, dim: int) -> Optional[str]:
        """FSDP-shard a dim over ``data`` if divisible."""
        return "data" if _div(dim, self.mesh, "data") else None

    def spec_for(self, path: str, shape: tuple) -> Spec:
        """The spec of the reference-layout leaf at ``path`` ("/"-joined
        keys) with ``shape``."""
        cfg = self.cfg
        name = path.split("/")[-1]
        H, KV = cfg.num_heads, cfg.num_kv_heads

        def attn_qkv(heads: int) -> tuple:
            # heads over model when divisible; otherwise the weights stay
            # FSDP-only (the reference then shards the sequence of q)
            if self.m(heads):
                return (self.d(shape[-3]), "model", None)
            return (self.d(shape[-3]), None, None)

        table = {
            "embed": lambda: (self.m(shape[-2]), self.d(shape[-1])),
            "lm_head": lambda: (self.d(shape[-2]), self.m(shape[-1])),
            "wq": lambda: attn_qkv(H),
            "wk": lambda: attn_qkv(KV),
            "wv": lambda: attn_qkv(KV),
            "wo": lambda: self._wo_spec(shape),
            "bq": lambda: (None, None),
            "bk": lambda: (None, None),
            "bv": lambda: (None, None),
            # dense mlp
            "w_gate": lambda: self._ffn_in(shape),
            "w_up": lambda: self._ffn_in(shape),
            "w_down": lambda: self._ffn_out(shape),
            # router
            "router": lambda: (self.d(shape[-2]), None),
            # mamba
            "in_proj": lambda: (self.d(shape[-2]), self.m(shape[-1])),
            "out_proj": lambda: (self.m(shape[-2]), self.d(shape[-1])),
            "conv_w": lambda: (None, self.m(shape[-1])),
            "conv_b": lambda: (self.m(shape[-1]),),
            "A_log": lambda: (None,),
            "D_skip": lambda: (None,),
            "dt_bias": lambda: (None,),
            "norm_scale": lambda: (None,),
            "scale": lambda: (None,),
        }
        if name not in table:
            raise KeyError(f"no sharding rule for param {path!r} {shape}")
        spec = table[name]()
        lead = len(shape) - len(spec)
        if lead < 0:
            raise ValueError(f"{path}: shape {shape} has fewer dims than "
                             f"its rule {spec}")
        return (None,) * lead + tuple(spec)

    def _ffn_in(self, shape) -> tuple:
        if len(shape) >= 3 and shape[-3] == self.cfg.num_experts and \
                self.cfg.family == "moe":
            # expert weights [E, D, Fe]: EP over model, else TP inner dim
            if self.m(shape[-3]):
                return ("model", self.d(shape[-2]), None)
            return (None, self.d(shape[-2]), self.m(shape[-1]))
        return (self.d(shape[-2]), self.m(shape[-1]))

    def _ffn_out(self, shape) -> tuple:
        if len(shape) >= 3 and shape[-3] == self.cfg.num_experts and \
                self.cfg.family == "moe":
            if self.m(shape[-3]):
                return ("model", None, self.d(shape[-1]))
            return (None, self.m(shape[-2]), self.d(shape[-1]))
        return (self.m(shape[-2]), self.d(shape[-1]))

    def _wo_spec(self, shape) -> tuple:
        if self.m(self.cfg.num_heads):
            return ("model", None, self.d(shape[-1]))
        return (None, None, self.d(shape[-1]))


def _map_tree(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict / list tree, in its layout."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (str(k),)) for k, v in
                tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params: Any, cfg: ModelConfig, mesh: Mesh) -> Any:
    """Specs for a model (a ``Transformer``, on any device: the meta
    device gives the full configs without memory) or a tree in the
    reference's layout, as a tree in the reference's layout."""
    if isinstance(params, Transformer):
        params = convert.reference_tree(
            {k: p.detach().to("meta") for k, p in params.named_parameters()},
            cfg)
    rules = Rules(mesh, cfg)
    return _map_tree(lambda path, leaf: rules.spec_for(
        "/".join(path), tuple(leaf.shape)), params)


def _bspec(mesh: Mesh, global_batch: int):
    """DP axes for the batch dim (one axis by its name, as a
    ``PartitionSpec`` entry reads), or None (replicate) when
    non-divisible."""
    dp = batch_axes(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    if global_batch % dp_size:
        return None
    return dp if len(dp) > 1 else dp[0]


def train_batch_specs(cfg: ModelConfig, mesh: Mesh, global_batch: int
                      ) -> dict:
    b = _bspec(mesh, global_batch)
    if cfg.external_embeddings:
        return {"embeds": (b, None, None), "labels": (b, None)}
    return {"tokens": (b, None), "labels": (b, None)}


def logits_spec(cfg: ModelConfig, mesh: Mesh, global_batch: int) -> Spec:
    return (_bspec(mesh, global_batch), None,
            Rules(mesh, cfg).m(cfg.vocab_size))


def cache_specs(cfg: ModelConfig, mesh: Mesh, batch: int, caches: Any
                ) -> Any:
    """Specs for the decode caches in the reference's layout
    (``convert.reference_caches``; meta tensors will do).

    KV caches [n, B, S, KV, Dh]: batch over DP when divisible, else context
    parallelism — the S axis over ``data``. Heads over ``model`` when
    divisible, else head_dim. SSM states [n, B, H, P, N]: heads over model
    (else the P dim)."""
    rules = Rules(mesh, cfg)
    b = _bspec(mesh, batch)

    def one(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        if name in ("k", "v"):
            n, B, S, KV, Dh = shape
            kv_ax = rules.m(KV)
            dh_ax = rules.m(Dh) if kv_ax is None else None
            seq_ax = None
            if b is None:
                seq_ax = "data" if S % mesh.shape["data"] == 0 else None
            return (None, b, seq_ax, kv_ax, dh_ax)
        if name == "pos":
            n, B, S = shape
            seq_ax = None
            if b is None:
                seq_ax = "data" if S % mesh.shape["data"] == 0 else None
            return (None, b, seq_ax)
        if name == "ssm":
            extra = len(shape) - 5
            _, B, H, Pd, N = shape[extra:]
            h_ax = rules.m(H)
            p_ax = rules.m(Pd) if h_ax is None else None
            return (None,) * (1 + extra) + (b, h_ax, p_ax, None)
        if name == "conv":
            extra = len(shape) - 4
            _, B, K, C = shape[extra:]
            return (None,) * (1 + extra) + (b, None, rules.m(C))
        raise KeyError(f"no cache rule for {name} {shape}")

    return _map_tree(one, caches)
