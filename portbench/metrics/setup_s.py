"""Set-up: process start to the first timed step (CUDA context, building or
loading the kernels, the runtime's threads, the seed's inputs, warm-up)."""


def read(obs):
    return obs.setup_s
