"""setup_s: process start to the first timed step or request, on the host
clock: weights made, model built, inputs made, every shape warmed."""


def read(out):
    return out["setup_s"]
