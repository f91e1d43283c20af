from .engine import DEFAULT_BUCKETS, bucket_length
from .serving import (BlockAllocator, OutOfBlocks, Request, RequestFailed,
                      RequestQueue, ServingEngine)

__all__ = ['BlockAllocator', 'DEFAULT_BUCKETS', 'OutOfBlocks', 'Request',
           'RequestFailed', 'RequestQueue', 'ServingEngine', 'bucket_length']
