"""Samplers: batch-of-chains discrete MCMC drivers."""
