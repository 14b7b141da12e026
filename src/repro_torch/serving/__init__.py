"""Serving tier: scheduler, paged cache manager, executor."""
