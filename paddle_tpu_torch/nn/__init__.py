from . import functional
from .layer import RMSNorm

__all__ = ['RMSNorm', 'functional']
