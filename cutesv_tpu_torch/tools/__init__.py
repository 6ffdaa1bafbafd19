"""Standalone tools: the synthetic long-read SV simulator."""
