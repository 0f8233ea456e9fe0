"""Remote-driver client (``rtpu://host:port``).

Counterpart of Ray Client (Ray's python/ray/util/client/:
worker.py client-side proxies, server/server.py the gRPC proxy): a thin
driver that holds NO local node — every put/get/submit/rpc crosses one TCP
connection to a ClientServer running next to the cluster head, which
executes them through its own attached driver context. The client-side
object is a WorkerContext drop-in, so the entire public API (remote
functions, actors, placement groups, state API) works unchanged over it.
"""

from ray_tpu_torch.util.client.client import ClientContext, connect_client
from ray_tpu_torch.util.client.server import ClientServer

__all__ = ["ClientContext", "ClientServer", "connect_client"]
