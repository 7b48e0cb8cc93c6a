"""MNIST-sum samplers (binary images; x2 evolves, x1 is fixed)."""
