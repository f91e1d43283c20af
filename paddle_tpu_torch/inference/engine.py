"""Prefill buckets (counterpart of paddle_tpu/inference/engine.py's
bucket helpers)."""
from __future__ import annotations

# powers of two: a prompt is right-padded to the smallest bucket that
# holds it
DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_length(seq_len, buckets=None):
    """Smallest bucket >= seq_len; past the largest bucket, the next
    power of two."""
    for b in (buckets or DEFAULT_BUCKETS):
        if b >= seq_len:
            return b
    b = 1
    while b < seq_len:
        b <<= 1
    return b
