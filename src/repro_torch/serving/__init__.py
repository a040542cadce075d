from repro_torch.serving.engine import Request, ServeConfig, ServingEngine

__all__ = ["Request", "ServeConfig", "ServingEngine"]
