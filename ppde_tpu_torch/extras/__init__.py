"""Auxiliary utilities kept for feature parity (low-N / Biswas toolkit)."""
