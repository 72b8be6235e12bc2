"""Each package's replication surface behind one namespace, so a scenario
runs unchanged on the reference and on the port (on the CPU) and the two
outcomes can be compared."""
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402,F401
from repro.core import commands as jcommands  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import query as jquery  # noqa: E402
from repro.core import shard_wal as jsw  # noqa: E402
from repro.core.state import init_state as jinit  # noqa: E402
from repro.net import client as jclient  # noqa: E402
from repro.net import protocol as jp  # noqa: E402
from repro.net import replica as jreplica  # noqa: E402
from repro.net import server as jserver  # noqa: E402
from repro.runtime import coordinator as jcoord  # noqa: E402
from repro_torch.core import commands as tcommands  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import query as tquery  # noqa: E402
from repro_torch.core import shard_wal as tsw  # noqa: E402
from repro_torch.core.state import init_state as tinit  # noqa: E402
from repro_torch.net import client as tclient  # noqa: E402
from repro_torch.net import protocol as tp  # noqa: E402
from repro_torch.net import replica as treplica  # noqa: E402
from repro_torch.net import server as tserver  # noqa: E402
from repro_torch.runtime import coordinator as tcoord  # noqa: E402
from _torch_net import CAP, D, SRC, jax_log, port_log  # noqa: E402

CPU = {"device": "cpu"}


def _kit(name, p, server, client, replica, coord, dist, sw, query, init,
         to_log, commands, dev, module):
    k = types.SimpleNamespace(name=name, p=p, server=server, rmod=replica,
                              coord=coord, dist=dist, sw=sw, query=query)
    k.Local = client.LocalTransport
    k.Socket = client.SocketTransport
    k.genesis = lambda: init(CAP, D, **dev)
    k.log = to_log
    k.to_bytes = commands.log_to_bytes
    # raw query rows as the package's read path takes them
    k.q = (lambda a: torch.tensor(a)) if dev else (lambda a: a)
    k.host = lambda d, g=None: server.ShardHost(d, g, **dev)
    k.client = lambda tr: client.RemoteShardClient(tr, **dev)
    k.replica = lambda primary, genesis=None, **kw: replica.ReplicaStore(
        primary, genesis, **kw, **({} if genesis is not None else dev))
    k.sharded_genesis = lambda n: dist.init_sharded_host(n, CAP, D, **dev)
    k.sharded_store = lambda d, **kw: sw.ShardedDurableStore(d, **kw, **dev)
    k.server_argv = [sys.executable, "-m", module, "--capacity", str(CAP),
                     "--dim", str(D), "--port", "0"] + (
        ["--device", "cpu"] if dev else [])
    return k


JAX = _kit("jax", jp, jserver, jclient, jreplica, jcoord, jdist, jsw, jquery,
           jinit, jax_log, jcommands, {}, "repro.net.server")
PORT = _kit("port", tp, tserver, tclient, treplica, tcoord, tdist, tsw,
            tquery, tinit, port_log, tcommands, CPU,
            "repro_torch.net.server")
KITS = (JAX, PORT)


def spawn_primary(kit, directory):
    """A real shard-server subprocess of ``kit``'s package (the thing a
    test can SIGKILL). Returns (proc, client factory)."""
    proc = subprocess.Popen(kit.server_argv + ["--dir", str(directory)],
                            stdout=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(SRC)))
    line = proc.stdout.readline().strip()
    assert line.startswith("LISTENING "), f"server failed: {line!r}"
    port = int(line.split()[1])
    return proc, lambda: kit.client(kit.Socket("127.0.0.1", port))


def both(scenario, tmp_path, *args):
    """Run ``scenario(kit, root, *args)`` on both packages; the outcomes
    must be equal. Returns the reference's."""
    out = [scenario(kit, tmp_path / kit.name, *args) for kit in KITS]
    assert out[1] == out[0], (out[0], out[1])
    return out[0]
