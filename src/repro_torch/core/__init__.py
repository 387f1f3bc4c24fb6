"""Compressor core: config, hashing, blocks, index, sketch, peeling,
sparsification, buckets, compressor, collectives and aggregators."""
