"""Serving control plane: request routers in front of engine replicas."""
