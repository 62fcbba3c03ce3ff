"""The measured window: a closed loop of one client.

A new proof starts only while `seconds` have not run out since the first
one started; every proof started is finished and counted, so a window lasts
up to one proof longer than `seconds`.  The window runs from the first
proof's start to the last one's end.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List


@dataclass
class Window:
    seconds: float = 0.0  # first start to last end
    walls: List[float] = field(default_factory=list)
    failed: int = 0

    @property
    def proofs(self) -> int:
        return len(self.walls)


def closed_loop(step: Callable[[int], bool], seconds: float,
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """Call step(0), step(1), ... while the window has time left; `step`
    returns False for a proof that failed."""
    win = Window()
    start = clock()
    while clock() - start < seconds:
        t0 = clock()
        if not step(len(win.walls)):
            win.failed += 1
        win.walls.append(clock() - t0)
    win.seconds = clock() - start
    return win
