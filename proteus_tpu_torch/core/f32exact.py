"""Host integer bounds: ``int_array OP float64_threshold`` as a pure
integer comparison.

Copied from ``proteus_tpu/core/f32exact.py:303-325`` (numpy only; that
module imports jax). The rest of that module, the division-free boundary
tests, exists because TPU float32 division is not correctly rounded and is
not ported: the port divides (``models/dswx/diagnostics.py``).
"""

from typing import Optional

import numpy as np


def int_gt_bound(t) -> Optional[int]:
    """Smallest integer B with (i > t) == (i >= B); None if never true."""
    tf = np.float64(t)
    if np.isnan(tf) or tf == np.inf:
        return None
    if tf == -np.inf:
        return -(2 ** 62)
    return int(np.floor(tf)) + 1


def int_lt_bound(t) -> Optional[int]:
    """Largest integer B with (i < t) == (i <= B); None if never true."""
    tf = np.float64(t)
    if np.isnan(tf) or tf == -np.inf:
        return None
    if tf == np.inf:
        return 2 ** 62
    ce = np.ceil(tf)
    return int(ce) - 1 if ce == tf else int(np.floor(tf))
