"""Token documents: int64 [n, ``length``] ids drawn uniformly over
``vocab``."""
from __future__ import annotations

import torch

from bench import generator


class Data:
    def __init__(self, data: dict, dim: int, seed: int, device):
        self.seed, self.device = int(seed), torch.device(device)
        self.length, self.vocab = int(data["length"]), int(data["vocab"])
        self._gen = torch.Generator(device=self.device)

    def batch(self, stream: str, index: int, n: int) -> torch.Tensor:
        g = self._gen
        g.manual_seed(generator.derive_seed(self.seed, stream, index))
        return torch.randint(0, self.vocab, (n, self.length), generator=g,
                             device=self.device)
