"""Gzip backend selection (reference: bionumpy/io/gzip_reading.py:1-4).

Prefers isal's igzip (SIMD inflate) when available; stdlib gzip otherwise.
"""
try:
    from isal import igzip as gzip  # noqa: F401
except ImportError:
    import gzip  # noqa: F401
