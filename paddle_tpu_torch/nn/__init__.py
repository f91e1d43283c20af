from . import functional, quant
from .clip import ClipGradByGlobalNorm
from .layer import RMSNorm

__all__ = ['ClipGradByGlobalNorm', 'RMSNorm', 'functional', 'quant']
