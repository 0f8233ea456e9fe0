"""@serve.deployment decorator + application graph (bind).

Counterpart of ``ray_tpu/serve/deployment.py``; that is, of the reference's
deployment API (Ray's python/ray/serve/deployment.py Deployment/Application,
python/ray/serve/api.py @serve.deployment): ``D.bind(*args)`` builds an
application DAG; bound child applications become DeploymentHandles at deploy
time (model composition via handle chaining).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig


def _wrap_function(fn: Callable) -> type:
    """Function deployments become a callable class (reference:
    serve/api.py handles both)."""

    class _FuncDeployment:
        def __call__(self, *args, **kwargs):
            return fn(*args, **kwargs)

    _FuncDeployment.__name__ = getattr(fn, "__name__", "func")
    return _FuncDeployment


@dataclass
class Application:
    """A bound deployment DAG node (reference: serve Application)."""

    deployment: "Deployment"
    args: Tuple = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)


class Deployment:
    def __init__(self, cls_or_fn: Union[type, Callable],
                 name: Optional[str] = None,
                 config: Optional[DeploymentConfig] = None):
        self._cls = (cls_or_fn if isinstance(cls_or_fn, type)
                     else _wrap_function(cls_or_fn))
        self.name = name or self._cls.__name__
        self.config = config or DeploymentConfig()

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                max_ongoing_requests: Optional[int] = None,
                autoscaling_config: Optional[Union[AutoscalingConfig,
                                                   dict]] = None,
                user_config: Optional[dict] = None,
                ray_actor_options: Optional[dict] = None,
                request_router_policy: Optional[str] = None,
                **_ignored) -> "Deployment":
        import copy

        cfg = copy.deepcopy(self.config)
        if request_router_policy is not None:
            cfg.request_router_policy = request_router_policy
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
        if user_config is not None:
            cfg.user_config = user_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = ray_actor_options
        return Deployment(self._cls, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment({self.name})"


def deployment(cls_or_fn=None, **options):
    """@serve.deployment or @serve.deployment(num_replicas=..., ...)."""

    def wrap(target):
        d = Deployment(target)
        if options:
            d = d.options(**options)
        return d

    if cls_or_fn is not None:
        return wrap(cls_or_fn)
    return wrap


def flatten_app(app: Application, app_name: str) -> Tuple[str, List[dict]]:
    """Walk the bound DAG depth-first; child Applications become handle
    placeholders resolved to DeploymentHandles at replica construction
    (reference: serve build graph, _private/api.py build_app)."""
    import cloudpickle

    specs: Dict[str, dict] = {}

    def visit(node: Application) -> dict:
        dep = node.deployment
        name = dep.name
        # de-dup by deployment name: same Deployment bound twice shares
        # replicas (reference semantics)
        args = tuple(visit(a) if isinstance(a, Application) else a
                     for a in node.args)
        kwargs = {k: (visit(v) if isinstance(v, Application) else v)
                  for k, v in node.kwargs.items()}
        spec = {
            "name": name,
            "cls_blob": cloudpickle.dumps(dep._cls),
            "init_args_blob": cloudpickle.dumps((args, kwargs)),
            "config": cloudpickle.dumps(dep.config),
        }
        # Path-aware ingress: a deployment exposing handle_http(request)
        # receives {path, method, body, query} instead of just the body
        # (reference: serve replicas receive the full ASGI scope).  Recorded
        # here so every deploy path (run(), config deploys, direct
        # controller calls) carries it in the spec.
        if hasattr(dep._cls, "handle_http"):
            spec["http_method"] = "handle_http"
        prev = specs.get(name)
        if prev is None:
            specs[name] = spec
        elif prev["init_args_blob"] != spec["init_args_blob"]:
            # Same Deployment bound twice with identical args shares
            # replicas; different args would be silently dropped — error
            # like the reference does on duplicate deployment names.
            raise ValueError(
                f"deployment {name!r} is bound more than once with "
                f"different arguments; use .options(name=...) to give "
                f"each binding a distinct name")
        return {"__serve_handle__": name}

    visit(app)
    ingress = app.deployment.name
    return ingress, list(specs.values())
