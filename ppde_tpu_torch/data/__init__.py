"""Datasets (MNIST-sum pairs and binary MNIST loaders), numpy only."""
