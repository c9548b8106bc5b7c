"""Helpers around the port's kernels: timing on the card."""
