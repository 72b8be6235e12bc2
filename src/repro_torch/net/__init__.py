"""Networked shard serving + log-shipping replication (DESIGN.md §8).

The port of ``repro.net``: a length-prefixed wire protocol whose every
frame carries a digest (``protocol``), a per-process shard host wrapping
one ``DurableStore`` plus its applied state on the host's device
(``server``), a client implementing the surface ``ShardedDurableStore``
drives locally (``client``), and a WAL-tailing read replica whose every
acked cursor is a verified ``state_hash`` match against the primary
(``replica``). Frames are byte-identical to the reference's, so a host of
either package serves a client of the other.

Exports resolve lazily so ``python -m repro_torch.net.server`` (the
shard-host entry point) does not import the package's own submodule twice.
"""
_EXPORTS = {
    "ProtocolError": "repro_torch.net.protocol",
    "RemoteError": "repro_torch.net.protocol",
    "StaleEpochError": "repro_torch.net.protocol",
    "TransportError": "repro_torch.net.protocol",
    "LocalTransport": "repro_torch.net.client",
    "RemoteShardClient": "repro_torch.net.client",
    "SocketTransport": "repro_torch.net.client",
    "remote_sharded_query": "repro_torch.net.client",
    "FollowerPolicy": "repro_torch.net.replica",
    "LocalPrimary": "repro_torch.net.replica",
    "ReplicaDivergence": "repro_torch.net.replica",
    "ReplicaStore": "repro_torch.net.replica",
    "ShardHost": "repro_torch.net.server",
    "ShardServer": "repro_torch.net.server",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.net' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(module), name)
