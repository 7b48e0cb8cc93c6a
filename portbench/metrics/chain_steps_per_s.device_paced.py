"""chain_steps_per_s.device_paced: the same rate as ``chain_steps_per_s``,
under its own, tighter bound, in the cells whose steps the device paces
(busy ~98%), where neither the host nor the seed moves the rate."""


def read(run):
    return run["chain_steps_per_s"]
