"""Set-up seconds: from the process's start (imports and CUDA start
included) to the first frame of the window: frames made, kernels built,
graphs captured, BA buckets prewarmed."""


def read(rec):
    return rec["setup_s"]
