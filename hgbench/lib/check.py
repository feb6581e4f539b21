"""What a comparison with the plain reference (hgbench/checks/<name>.py)
is made of.

A check is installed on the program's objects during set-up, keeps a
sample, drawn from the seed, of the answers the timed window produces
(`Reservoir`), and after the window, once the program's state is freed,
reads each compared number: the worst gap over its sample. With
`control`, the reference computed one precision lower stands in the
program's place for every sampled answer."""

from __future__ import annotations

import threading

import numpy as np

from hgbench.gen.stream import seed_bits


class Reservoir:
    """A uniform sample of k of the items offered while `open` (Algorithm
    R, its draws from the seed)."""

    def __init__(self, k: int, seed: int, salt: int):
        self.k = k
        self.items = []
        self.seen = 0
        self.open = False
        self._rng = np.random.default_rng(seed_bits(seed, salt))
        self._lock = threading.Lock()  # offered from the pose graph's worker thread too

    def offer(self, make):
        """Offer the item make() builds (built only when kept); returns the
        item where it was kept, else None."""
        with self._lock:
            if not self.open:
                return None
            i = self.seen
            self.seen += 1
            if i < self.k:
                self.items.append(make())
                return self.items[-1]
            j = int(self._rng.integers(0, i + 1))
            if j < self.k:
                self.items[j] = make()
                return self.items[j]
            return None


class Check:
    """Base: `numbers(control)` returns {name: value} over the sample."""

    salt = 0

    def __init__(self, session, k: int):
        self.session = session
        self.sample = Reservoir(k, session.seed, self.salt)

    def open(self):
        self.sample.open = True

    def close(self):
        self.sample.open = False

    def numbers(self, control: bool) -> dict:
        raise NotImplementedError
