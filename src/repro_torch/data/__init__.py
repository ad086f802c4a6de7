"""Token data pipeline: a verbatim copy of the reference package's numpy-only
``data/pipeline.py`` (synthetic and memory-mapped token streams, prefetch)."""
