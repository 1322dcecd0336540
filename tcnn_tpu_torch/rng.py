"""PCG32 random number generator (numpy, bit-exact with ``tcnn_tpu.rng``).

PCG32 (M.E. O'Neill, www.pcg-random.org) is what the reference uses for
parameter initialization (reference: dependencies/pcg32/pcg32.h,
trainer.h:81-84). Init happens once on the host, so numpy is enough: the
whole state sequence of a draw is materialized with O(log n) vectorized
doubling steps.
"""

from __future__ import annotations

import numpy as np

PCG32_DEFAULT_STATE = np.uint64(0x853C49E6748FEA9B)
PCG32_DEFAULT_STREAM = np.uint64(0xDA3E39CB94B95BDB)
PCG32_MULT = np.uint64(0x5851F42D4C957F2D)

_u64 = np.uint64
_u32 = np.uint32
_MASK64 = (1 << 64) - 1


class PCG32:
    """Scalar-state PCG32 with batched draws."""

    def __init__(self, initstate: int = None, initseq: int = 1):
        if initstate is None:
            self.state = PCG32_DEFAULT_STATE
            self.inc = PCG32_DEFAULT_STREAM
        else:
            self.seed(initstate, initseq)

    def seed(self, initstate: int, initseq: int = 1):
        self.state = _u64(0)
        self.inc = _u64((int(initseq) << 1 | 1) & _MASK64)
        self.next_uint()
        self.state = _u64((int(self.state) + int(initstate)) & _MASK64)
        self.next_uint()

    def next_uint(self, n: int = None):
        """One uint32 draw (n=None) or an array of n draws."""
        if n is None:
            return self._draw(1)[0]
        return self._draw(n)

    def _draw(self, n: int) -> np.ndarray:
        # The LCG is the affine recurrence s' = a*s + c (mod 2^64).
        states = np.empty(n, dtype=np.uint64)
        states[0] = self.state
        filled = 1
        a_k = int(PCG32_MULT)  # affine coefficients for a jump of `filled`
        c_k = int(self.inc)
        with np.errstate(over="ignore"):
            while filled < n:
                take = min(filled, n - filled)
                states[filled : filled + take] = states[:take] * _u64(a_k) + _u64(c_k)
                filled += take
                c_k = (a_k * c_k + c_k) & _MASK64
                a_k = (a_k * a_k) & _MASK64
        out = self._output(states)
        last = int(states[n - 1])
        self.state = _u64((last * int(PCG32_MULT) + int(self.inc)) & _MASK64)
        return out

    @staticmethod
    def _output(oldstate: np.ndarray) -> np.ndarray:
        xorshifted = (((oldstate >> _u64(18)) ^ oldstate) >> _u64(27)).astype(np.uint32)
        rot = (oldstate >> _u64(59)).astype(np.uint32)
        return (xorshifted >> rot) | (xorshifted << ((~rot + _u32(1)) & _u32(31)))

    def next_float(self, n: int = None):
        """Uniform float32 in [0, 1): generate in [1,2) and subtract 1."""
        bits = self.next_uint(n)
        bits = (np.asarray(bits, dtype=np.uint32) >> _u32(9)) | _u32(0x3F800000)
        out = bits.view(np.float32) - np.float32(1.0)
        if n is None:
            return out.reshape(())[()]
        return out

    def advance(self, delta: int):
        """Multi-step jump-ahead (O(log n) modular exponentiation)."""
        cur_mult = int(PCG32_MULT)
        cur_plus = int(self.inc)
        acc_mult = 1
        acc_plus = 0
        delta = delta & _MASK64
        while delta > 0:
            if delta & 1:
                acc_mult = (acc_mult * cur_mult) & _MASK64
                acc_plus = (acc_plus * cur_mult + cur_plus) & _MASK64
            cur_plus = ((cur_mult + 1) * cur_plus) & _MASK64
            cur_mult = (cur_mult * cur_mult) & _MASK64
            delta >>= 1
        self.state = _u64((acc_mult * int(self.state) + acc_plus) & _MASK64)


def make_rng(seed: int = 1337) -> PCG32:
    """Default RNG factory mirroring ``default_rng_t`` usage."""
    return PCG32(seed)


# Batched distributions (reference: random.h:38-85; tcnn_tpu/rng.py:136-146).


def generate_random_uniform(rng: PCG32, n: int, low: float = 0.0, high: float = 1.0) -> np.ndarray:
    """n fp32 uniforms in [low, high) from ``rng``'s next n floats."""
    return (rng.next_float(n) * (high - low) + low).astype(np.float32)


def generate_random_logistic(rng: PCG32, n: int, mean: float = 0.0, stddev: float = 1.0) -> np.ndarray:
    """n fp32 logistic draws of the given mean and standard deviation
    (sqrt(3) / pi * stddev is the scale), computed in fp64 from ``rng``'s
    next n floats, each clipped to [1e-12, 1 - 1e-12]."""
    u = np.clip(rng.next_float(n).astype(np.float64), 1e-12, 1 - 1e-12)
    return (mean + stddev * 0.551328895421792050 * np.log(u / (1 - u))).astype(np.float32)
