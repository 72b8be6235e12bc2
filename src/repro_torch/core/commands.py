"""Integer-encoded command log (paper §3.1, §5.2).

Commands are the only way memory state changes; the log is the replayable
audit trail. A struct-of-arrays dataclass of tensors, one device:

  opcode int32 [n]; arg0 int64 [n] (id / src id); arg1 int64 [n] (dst id /
  meta slot); arg2 int64 [n] (meta value); vec storage [n, dim] (INSERT
  payload, zeros otherwise).

Opcodes: NOP=0, INSERT=1, DELETE=2, LINK=3, UNLINK=4, SET_META=5.
``log_to_bytes`` is byte-identical to the reference's serialization, so a
log written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.contracts import DEFAULT_CONTRACT, PrecisionContract
from repro_torch.core.state import resolve_device

NOP, INSERT, DELETE, LINK, UNLINK, SET_META = range(6)
NUM_OPCODES = 6
OPCODE_NAMES = ["NOP", "INSERT", "DELETE", "LINK", "UNLINK", "SET_META"]
FIELDS = ("opcode", "arg0", "arg1", "arg2", "vec")


@dataclasses.dataclass(frozen=True)
class CommandLog:
    opcode: torch.Tensor  # [n] int32
    arg0: torch.Tensor    # [n] int64
    arg1: torch.Tensor    # [n] int64
    arg2: torch.Tensor    # [n] int64
    vec: torch.Tensor     # [n, dim] contract storage dtype

    def __len__(self) -> int:
        return self.opcode.shape[0]

    @property
    def dim(self) -> int:
        return self.vec.shape[1]

    @property
    def device(self) -> torch.device:
        return self.opcode.device

    def _map(self, fn) -> "CommandLog":
        return CommandLog(**{f: fn(getattr(self, f)) for f in FIELDS})

    def concat(self, other: "CommandLog") -> "CommandLog":
        return CommandLog(**{f: torch.cat([getattr(self, f), getattr(other, f)])
                             for f in FIELDS})

    def slice(self, start: int, stop: int) -> "CommandLog":
        return self._map(lambda a: a[start:stop])

    def record(self, i) -> "CommandLog":
        """Command ``i`` as a one-command log (``machine.apply_command``
        takes one); negative ``i`` counts from the end."""
        i = range(len(self))[int(i)]
        return self.slice(i, i + 1)

    def take(self, order: torch.Tensor) -> "CommandLog":
        return self._map(lambda a: a[order])

    def to(self, device) -> "CommandLog":
        return self._map(lambda a: a.to(device))


def empty_log(dim: int, contract: PrecisionContract = DEFAULT_CONTRACT,
              device=None) -> CommandLog:
    dev = resolve_device(device)
    z = lambda dt: torch.zeros((0,), dtype=dt, device=dev)  # noqa: E731
    return CommandLog(opcode=z(torch.int32), arg0=z(torch.int64),
                      arg1=z(torch.int64), arg2=z(torch.int64),
                      vec=torch.zeros((0, dim), dtype=contract.storage_dtype,
                                      device=dev))


def _mk(opcode, dim, contract, a0=0, a1=0, a2=0, vec=None,
        device=None) -> CommandLog:
    if device is None and isinstance(vec, torch.Tensor):
        dev = vec.device
    else:
        dev = resolve_device(device)
    if vec is None:
        v = torch.zeros((1, dim), dtype=contract.storage_dtype, device=dev)
    else:
        v = torch.as_tensor(vec, device=dev)[None].to(contract.storage_dtype)

    def one(x, dt):
        return torch.tensor([int(x)], dtype=dt, device=dev)

    return CommandLog(opcode=one(opcode, torch.int32), arg0=one(a0, torch.int64),
                      arg1=one(a1, torch.int64), arg2=one(a2, torch.int64),
                      vec=v)


def insert_cmd(ext_id, raw_vec, contract: PrecisionContract = DEFAULT_CONTRACT,
               device=None) -> CommandLog:
    """raw_vec must already be fixed-point (post-boundary)."""
    return _mk(INSERT, raw_vec.shape[-1], contract, a0=ext_id, vec=raw_vec,
               device=device)


def delete_cmd(ext_id, dim, contract: PrecisionContract = DEFAULT_CONTRACT,
               device=None) -> CommandLog:
    return _mk(DELETE, dim, contract, a0=ext_id, device=device)


def link_cmd(src_id, dst_id, dim, contract: PrecisionContract = DEFAULT_CONTRACT,
             device=None) -> CommandLog:
    return _mk(LINK, dim, contract, a0=src_id, a1=dst_id, device=device)


def unlink_cmd(src_id, dst_id, dim,
               contract: PrecisionContract = DEFAULT_CONTRACT,
               device=None) -> CommandLog:
    return _mk(UNLINK, dim, contract, a0=src_id, a1=dst_id, device=device)


def set_meta_cmd(ext_id, slot, value, dim,
                 contract: PrecisionContract = DEFAULT_CONTRACT,
                 device=None) -> CommandLog:
    return _mk(SET_META, dim, contract, a0=ext_id, a1=slot, a2=value,
               device=device)


def insert_batch(ext_ids: torch.Tensor, raw_vecs: torch.Tensor,
                 contract: PrecisionContract = DEFAULT_CONTRACT) -> CommandLog:
    """Batch of INSERTs in canonical (sorted-by-id, stable) order, on the
    device of ``raw_vecs``."""
    dev = raw_vecs.device
    ext_ids = torch.as_tensor(ext_ids, device=dev).to(torch.int64)
    order = torch.argsort(ext_ids, stable=True)
    n = raw_vecs.shape[0]
    zeros = torch.zeros((n,), dtype=torch.int64, device=dev)
    return CommandLog(
        opcode=torch.full((n,), INSERT, dtype=torch.int32, device=dev),
        arg0=ext_ids[order], arg1=zeros, arg2=zeros.clone(),
        vec=raw_vecs[order].to(contract.storage_dtype))


def delete_batch(ext_ids, dim: int,
                 contract: PrecisionContract = DEFAULT_CONTRACT,
                 device=None) -> CommandLog:
    """Batch of DELETEs in canonical (sorted-by-id) order."""
    if device is None and isinstance(ext_ids, torch.Tensor):
        dev = ext_ids.device
    else:
        dev = resolve_device(device)
    ext_ids = torch.as_tensor(ext_ids, device=dev).to(torch.int64)
    ext_ids = ext_ids[torch.argsort(ext_ids, stable=True)]
    n = ext_ids.shape[0]
    zeros = torch.zeros((n,), dtype=torch.int64, device=dev)
    return CommandLog(
        opcode=torch.full((n,), DELETE, dtype=torch.int32, device=dev),
        arg0=ext_ids, arg1=zeros, arg2=zeros.clone(),
        vec=torch.zeros((n, dim), dtype=contract.storage_dtype, device=dev))


def canonicalize_batch(log: CommandLog) -> CommandLog:
    """Sort a same-opcode batch by (arg0, arg1) — only for order-free
    batches (pure inserts or pure links)."""
    key = log.arg0 * (1 << 20) + torch.clamp(log.arg1, 0, (1 << 20) - 1)
    return log.take(torch.argsort(key, stable=True))


# --------------------------------------------------------------------------- #
# host-side serialization and carry-over
# --------------------------------------------------------------------------- #


def log_to_numpy(log: CommandLog) -> Dict[str, np.ndarray]:
    return {f: getattr(log, f).detach().cpu().numpy() for f in FIELDS}


def log_from_numpy(arrays: Dict[str, np.ndarray],
                   contract: PrecisionContract = DEFAULT_CONTRACT,
                   device=None) -> CommandLog:
    """A log from numpy arrays keyed by field name; the vec payload takes
    the contract's storage dtype."""
    dev = resolve_device(device)
    dtypes = {"opcode": torch.int32, "arg0": torch.int64, "arg1": torch.int64,
              "arg2": torch.int64, "vec": contract.storage_dtype}
    return CommandLog(**{
        f: torch.from_numpy(np.array(arrays[f], copy=True)).to(
            device=dev, dtype=dtypes[f]) for f in FIELDS})


def log_to_bytes(log: CommandLog) -> bytes:
    """Canonical little-endian serialization of a command log."""
    arrays = log_to_numpy(log)
    header = np.asarray([len(log), log.dim, arrays["vec"].dtype.itemsize],
                        dtype="<i8")
    parts = [header.tobytes()]
    for name in FIELDS:
        arr = arrays[name]
        parts.append(arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return b"".join(parts)


def log_from_bytes(data: bytes, contract: PrecisionContract = DEFAULT_CONTRACT,
                   device=None) -> CommandLog:
    n, dim, isz = (int(v) for v in np.frombuffer(data[:24], dtype="<i8"))
    off = 24

    def take(dtype, count):
        nonlocal off
        nbytes = np.dtype(dtype).itemsize * count
        arr = np.frombuffer(data[off:off + nbytes], dtype=dtype)
        off += nbytes
        return arr

    arrays = {"opcode": take("<i4", n), "arg0": take("<i8", n),
              "arg1": take("<i8", n), "arg2": take("<i8", n)}
    vdt = {1: "<i1", 2: "<i2", 4: "<i4", 8: "<i8"}[isz]
    arrays["vec"] = take(vdt, n * dim).reshape(n, dim)
    return log_from_numpy(arrays, contract, device=device)
