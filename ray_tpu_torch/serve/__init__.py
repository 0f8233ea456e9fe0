"""ray_tpu_torch.serve: model serving on the port's actor runtime.

Counterpart of ``ray_tpu/serve/`` (Ray Serve): the controller actor
reconciles deployment replica sets; the aiohttp proxy routes HTTP to the
ingress deployment; DeploymentHandles route calls through the process-wide
request routers (``request_router/``: power-of-two-choices or
prefix-aware); autoscaling follows replica queue lengths.  Replicas are
actors of the port's runtime, each in its own process: a deployment asking
``ray_actor_options={"num_gpus": ...}`` runs its engine on the card there.
"""

from ray_tpu_torch.serve.api import (
    delete,
    get_app_handle,
    grpc_port,
    http_port,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.streaming import HTTPResponse, StreamingResponse, ingress

__all__ = [
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "DeploymentResponse",
    "delete",
    "deployment",
    "get_app_handle",
    "get_multiplexed_model_id",
    "multiplexed",
    "HTTPResponse",
    "StreamingResponse",
    "ingress",
    "grpc_port",
    "http_port",
    "run",
    "shutdown",
    "start",
    "status",
]
