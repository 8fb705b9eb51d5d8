"""Synthetic token pipeline with host prefetch."""
