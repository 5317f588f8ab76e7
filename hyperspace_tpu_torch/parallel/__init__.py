"""Host-side parallelism: the pooled ordered reader and the prefetcher."""
