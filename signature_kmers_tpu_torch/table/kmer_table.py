"""StoredKmerData value packing shared by the table layouts."""

from __future__ import annotations

import numpy as np


def pack_values(avg_from_end, function_index, mean, median, var):
    """Per-key statistics -> the three uint32 value words
    (v0 = function<<16 | avg_from_end, v1 = median<<16 | mean, v2 = var)."""
    a = np.asarray(avg_from_end, dtype=np.uint32)
    f = np.asarray(function_index, dtype=np.uint32)
    me = np.asarray(mean, dtype=np.uint32)
    md = np.asarray(median, dtype=np.uint32)
    v = np.asarray(var, dtype=np.uint32)
    return (f << 16) | a, (md << 16) | me, v
