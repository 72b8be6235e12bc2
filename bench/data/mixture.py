"""Clustered float32 embeddings: ``clusters`` centres drawn N(0, I_latent)
in a ``latent``-dimensional space, each vector a uniformly chosen centre
plus ``spread`` * N(0, I_latent), mapped to the full width by a fixed
N(0, 1 / latent) matrix, plus ``noise`` * N(0, I_dim). Documents and
queries are drawn alike, from streams of their own."""
from __future__ import annotations

import torch

from bench import generator


class Data:
    def __init__(self, data: dict, dim: int, seed: int, device):
        self.dim, self.seed, self.device = dim, int(seed), torch.device(device)
        self.clusters, self.latent = int(data["clusters"]), int(data["latent"])
        self.spread, self.noise = float(data["spread"]), float(data["noise"])
        g = self._gen = torch.Generator(device=self.device)
        g.manual_seed(generator.derive_seed(seed, "centres", 0))
        self.centres = torch.randn(self.clusters, self.latent, generator=g,
                                   device=self.device)
        self.basis = torch.randn(self.latent, dim, generator=g,
                                 device=self.device) / self.latent ** 0.5

    def batch(self, stream: str, index: int, n: int) -> torch.Tensor:
        """float32 [n, dim]: batch ``index`` of ``stream``."""
        g = self._gen
        g.manual_seed(generator.derive_seed(self.seed, stream, index))
        pick = torch.randint(0, self.clusters, (n,), generator=g,
                             device=self.device)
        u = self.centres[pick] + self.spread * torch.randn(
            n, self.latent, generator=g, device=self.device)
        return u @ self.basis + self.noise * torch.randn(
            n, self.dim, generator=g, device=self.device)
