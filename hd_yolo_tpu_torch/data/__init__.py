"""Batched preprocessing."""
