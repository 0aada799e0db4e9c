"""Host utilities: content digests and bounded LRU caches."""
