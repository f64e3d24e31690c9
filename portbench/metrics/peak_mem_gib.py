"""``torch.cuda.max_memory_allocated()`` of the fullest card over set-up and
window, read before the reference runs, in GiB."""


def read(obs):
    return obs.peak_bytes / 2**30 if obs.peak_bytes else None
