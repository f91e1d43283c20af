from . import functional
from .clip import ClipGradByGlobalNorm
from .layer import RMSNorm

__all__ = ['ClipGradByGlobalNorm', 'RMSNorm', 'functional']
