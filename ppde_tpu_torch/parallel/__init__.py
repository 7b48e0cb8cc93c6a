"""Multi-device runs: the device mesh and sharding (``mesh``), and the ESM2
pipeline (``pipeline``, imported on its own: it imports ``models.esm2``,
which imports ``mesh``)."""

from ppde_tpu_torch.parallel import mesh  # noqa: F401
