"""Paged KV pool, eviction policies and importance scores."""
