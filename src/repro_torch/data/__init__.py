from repro_torch.data.pipeline import DataConfig, TokenStream, request_stream

__all__ = ["DataConfig", "TokenStream", "request_stream"]
