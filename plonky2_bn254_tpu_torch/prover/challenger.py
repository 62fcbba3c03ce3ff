"""Fiat-Shamir challenger: Poseidon duplex sponge over Goldilocks.

Copy of `plonky2_bn254_tpu/prover/challenger.py` on the port's host Poseidon
(tests/test_torch_isolation.py pins the two transcripts together).  The
state is 12 field elements and squeezes are few, so it runs on python ints.
"""

from __future__ import annotations

from typing import List

from ..field import goldilocks as gl
from ..field.extension import GLExt
from ..field.poseidon import SPONGE_RATE, WIDTH, h_permute


class Challenger:
    def __init__(self):
        self.state = [0] * WIDTH
        self.input_buffer: List[int] = []
        self.output_buffer: List[int] = []

    # -- absorbing --------------------------------------------------------

    def observe_element(self, x: int):
        assert 0 <= x < gl.P
        self.output_buffer = []  # any new input invalidates pending outputs
        self.input_buffer.append(x)
        if len(self.input_buffer) == SPONGE_RATE:
            self._duplex()

    def observe_elements(self, xs):
        for x in xs:
            self.observe_element(int(x))

    def observe_cap(self, cap):
        """cap: iterable of 4-element digests."""
        for digest in cap:
            self.observe_elements(digest)

    def observe_extension(self, x: GLExt):
        self.observe_elements([x.c0, x.c1])

    # -- squeezing --------------------------------------------------------

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> List[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> GLExt:
        c0 = self.get_challenge()
        c1 = self.get_challenge()
        return GLExt(c0, c1)

    # -- internals --------------------------------------------------------

    def _duplex(self):
        for i, x in enumerate(self.input_buffer[:SPONGE_RATE]):
            self.state[i] = x
        self.input_buffer = self.input_buffer[SPONGE_RATE:]
        self.state = h_permute(self.state)
        self.output_buffer = list(self.state[:SPONGE_RATE])
        if self.input_buffer:
            self._duplex()

    def fork(self) -> "Challenger":
        c = Challenger()
        c.state = list(self.state)
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c
