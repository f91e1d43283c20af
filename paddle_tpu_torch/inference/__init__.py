from .engine import DEFAULT_BUCKETS, DecodeEngine, bucket_length
from .serving import (BlockAllocator, InvalidSamplingParams, OutOfBlocks,
                      Request, RequestFailed, RequestQueue, ServingEngine,
                      prompt_page_hashes)

__all__ = ['BlockAllocator', 'DEFAULT_BUCKETS', 'DecodeEngine',
           'InvalidSamplingParams', 'OutOfBlocks', 'Request', 'RequestFailed',
           'RequestQueue', 'ServingEngine', 'bucket_length',
           'prompt_page_hashes']
