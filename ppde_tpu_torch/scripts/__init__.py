"""Entry points of the port, run as
``python -m ppde_tpu_torch.scripts.<name>``."""
