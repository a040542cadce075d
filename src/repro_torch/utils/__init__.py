from repro_torch.utils.stats import mean_confidence_interval, pearson
