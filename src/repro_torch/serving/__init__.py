from repro_torch.serving.engine import MigratedRequest, Request, ServeConfig, ServingEngine

__all__ = ["MigratedRequest", "Request", "ServeConfig", "ServingEngine"]
