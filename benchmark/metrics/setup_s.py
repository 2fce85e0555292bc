"""setup_s: process start to the window's start (import, kernel build or
load, inputs, warm-up), host clock."""


def read(run):
    return run.setup_s
