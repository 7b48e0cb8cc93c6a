"""Protein-domain samplers over [n_chains, L, 20] one-hot populations."""
