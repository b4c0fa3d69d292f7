"""Process start to the window's first round (host clock): building the
extensions on a checkout's first run, the weights, the batcher, the
warm-up of every join width and decode graph, and the ramp to steady
traffic."""


def read(run):
    return run.setup_s
