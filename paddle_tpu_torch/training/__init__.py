from .engine import TrainEngine

__all__ = ['TrainEngine']
