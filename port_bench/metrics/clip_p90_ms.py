"""clip_p90_ms: the 90th percentile (linear interpolation) of the clips'
latency over every clip completed in the window, from the clip's upload
call to its CSV written. Host clock."""

import numpy as np


def read(run):
    if run.kind != "serve" or not run.clips:
        return None
    return float(np.percentile([c[2] for c in run.clips], 90)) * 1e3
