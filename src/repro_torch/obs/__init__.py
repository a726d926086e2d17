"""Serving counters (numpy/host only)."""
