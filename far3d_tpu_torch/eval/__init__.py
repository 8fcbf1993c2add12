"""Streaming evaluation and the AV2 detection metrics."""
