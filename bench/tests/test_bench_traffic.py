"""The traffic generator: deterministic by seed, any seed."""
import pytest
import torch

from bench import generator

DATA = {"kind": "mixture", "clusters": 8, "latent": 6, "spread": 1.0,
        "noise": 0.1}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_batches_repeat_by_seed(seed):
    a = generator.make(DATA, 37, seed, "cpu")
    b = generator.make(DATA, 37, seed, "cpu")
    x = a.batch("ingest", 3, 5)
    assert x.shape == (5, 37) and x.dtype == torch.float32
    assert torch.equal(x, b.batch("ingest", 3, 5))
    # drawing other batches first changes nothing
    a.batch("read", 0, 9)
    assert torch.equal(x, a.batch("ingest", 3, 5))
    assert not torch.equal(x, a.batch("ingest", 4, 5))
    assert not torch.equal(x, a.batch("read", 3, 5))


def test_seeds_differ_and_fit():
    seeds = {generator.derive_seed(s, "ingest", i) for s in (1, 2, 2**31 + 1)
             for i in range(4)}
    assert generator.derive_seed(5, "fill", 0) != \
        generator.derive_seed(5, "read", 0)
    assert len(seeds) == 12
    assert all(0 <= s < 2**63 for s in seeds)
    a = generator.make(DATA, 16, 1, "cpu")
    b = generator.make(DATA, 16, 2, "cpu")
    assert not torch.equal(a.batch("fill", 0, 4), b.batch("fill", 0, 4))


def test_token_documents_repeat_by_seed():
    data = {"kind": "tokens", "length": 16, "vocab": 512}
    a = generator.make(data, 0, 2**31 + 5, "cpu")
    x = a.batch("ingest", 2, 4)
    assert x.shape == (4, 16) and int(x.min()) >= 0 and int(x.max()) < 512
    assert torch.equal(x, generator.make(data, 0, 2**31 + 5, "cpu").batch(
        "ingest", 2, 4))
    assert not torch.equal(x, a.batch("ingest", 3, 4))
