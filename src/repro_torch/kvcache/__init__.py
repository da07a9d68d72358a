"""Paged, ECF8-compressed KV cache.

``paged``   — fixed-size pages, per-slot page tables, free-list allocator
              (one free list a batch shard on a mesh), the compressed cold
              pool, the swap tier's evict / fault, and the page write /
              gather of the decode step.
``codec``   — lossless exponent-plane entropy codec for cache pages
              (fp8 / bf16 / f32), canonical Huffman per page; the host
              encoder and the plain PyTorch page decode.
``kernels`` — the CUDA page-decode kernel (``csrc/kv_page_decode.cu``)
              that decodes cold pages in the decode step and swapped pages
              on fault (``decode_pages_sharded``: a rank's own cold slots).
``swap``    — host-side swap tier: entropy-coded pages leave the device
              entirely (hot -> cold -> swapped) and restore bit-exactly.
"""
from . import codec, kernels, paged, swap  # noqa: F401
from .paged import GARBAGE_PAGE, OutOfPages, PagedKVCache, PrefixIndex  # noqa: F401
from .swap import SwapExhausted, SwapStore  # noqa: F401
