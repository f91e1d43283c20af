from .engine import DEFAULT_BUCKETS, DecodeEngine, bucket_length
from .serving import (BlockAllocator, OutOfBlocks, Request, RequestFailed,
                      RequestQueue, ServingEngine)

__all__ = ['BlockAllocator', 'DEFAULT_BUCKETS', 'DecodeEngine', 'OutOfBlocks',
           'Request', 'RequestFailed', 'RequestQueue', 'ServingEngine',
           'bucket_length']
