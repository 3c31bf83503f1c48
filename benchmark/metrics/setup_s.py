"""Set-up seconds: from the process's start to the window's, imports,
inputs, weights, the program's build and every warm-up included."""


def read(run):
    return run.setup_s
