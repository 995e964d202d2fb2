"""The 95th percentile (numpy's linear rule) of the window's step times: the
device-timeline interval between the CUDA events recorded after each call."""

import numpy as np

SOURCE = "device_trace"


def read(r):
    if not r.window["call_s"]:
        return None
    return float(np.percentile(np.asarray(r.window["call_s"]) * 1e3, 95))
