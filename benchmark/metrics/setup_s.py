"""Seconds from the start of the process to the start of the window:
imports, the kernels' build (first run in a checkout), inputs and weights,
the program's set-up and the warm-up of every shape the traffic uses."""


def read(run):
    return run.setup_s
