from ray_tpu_torch.air.execution.actor_manager import ActorManager, TrackedActor

__all__ = ["ActorManager", "TrackedActor"]
