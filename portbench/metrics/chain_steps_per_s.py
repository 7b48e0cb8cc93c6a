"""chain_steps_per_s: chains times every step of the window over every
second of the window's call, start to return (host clock)."""


def read(run):
    return run["chain_steps_per_s"]
