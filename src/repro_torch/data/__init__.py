from repro_torch.data.pipeline import request_stream

__all__ = ["request_stream"]
