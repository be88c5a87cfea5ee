"""States on which the ARC4 kernel's lookahead corrections fire often, the
kernel's test inputs (the PRGA is defined on any 256 bytes, as the
reference's scan is).

Not a test module: ``tests/test_torch_arc4.py``, ``test_torch_arc4_host.py``
and ``test_torch_cuda.py`` import it, and ``chip_smoke.py`` loads it by path.
"""

import numpy as np


def collision_states(s: int, seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """S states, in the reference's ``(x, y, m)`` uint32 form (shapes (S,),
    (S,), (S, 256)). Stream i takes its kind from i mod 6: the identity
    permutation; bytes mostly 1 with y = x + d for d = 1, 2, 3 and -1, so
    that while a = 1 byte after byte y_j lands on x_{j+1}, x_{j+2}, x_{j+3}
    or x_{j-1}; bytes mostly 0, so that y_j == y_{j-1}. The other bytes of
    the last five kinds are random, so that a wrong correction shows."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, s)
    y = rng.integers(0, 256, s)
    m = rng.integers(0, 256, (s, 256))
    for i in range(s):
        kind = i % 6
        if kind == 0:
            m[i] = np.arange(256)
            continue
        fill = rng.random(256) < 0.7
        m[i, fill] = 0 if kind == 5 else 1
        if kind < 5:
            y[i] = (x[i] + (1, 2, 3, -1)[kind - 1]) & 255
    return x.astype(np.uint32), y.astype(np.uint32), m.astype(np.uint32)
