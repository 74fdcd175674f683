"""The 95th percentile, over every frame due in the live window, of the
milliseconds from its last required input's due time to its pose on the
host."""

import numpy as np


def read(run):
    lat = [(f.out - f.due) * 1e3 for f in run.frames if np.isfinite(f.due)]
    return float(np.percentile(lat, 95)) if lat else None
