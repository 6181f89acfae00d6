from .pipeline import DataState, SyntheticLM

__all__ = ["DataState", "SyntheticLM"]
