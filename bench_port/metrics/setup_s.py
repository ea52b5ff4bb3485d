"""Set-up time: process start to the first timed call (imports, the kernel
library, weights, the pool, warm-up; a training cell's first steps)."""


def read(r):
    return r.setup_s
