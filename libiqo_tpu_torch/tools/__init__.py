"""Measurement tools for the port; each runs on one CUDA device."""
