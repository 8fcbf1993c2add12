"""Weights and synthetic inputs for the port."""
