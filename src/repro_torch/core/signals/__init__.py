from repro_torch.core.signals.analysis import (
    burst_lead_report,
    ema,
    lag_correlation_table,
    windowed_variation,
)

__all__ = ["ema", "lag_correlation_table", "windowed_variation", "burst_lead_report"]
