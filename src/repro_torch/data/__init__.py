from .pipeline import DataConfig, PrefetchIterator, SyntheticLM

__all__ = ["DataConfig", "PrefetchIterator", "SyntheticLM"]
