"""Preprocessing: zscale limits and the README chain with its fused kernel."""
