from dgll_tpu_torch.cache.feature_cache import HBMFeatureCache

__all__ = ["HBMFeatureCache"]
