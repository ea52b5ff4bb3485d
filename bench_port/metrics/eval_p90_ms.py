"""The 90th percentile (nearest rank) of one call's latency, from the call to
its outputs synchronised, over every call of the window."""

import math


def read(r):
    lat = sorted(r.latencies_s)
    return 1e3 * lat[math.ceil(0.9 * len(lat)) - 1]
