"""FFT size selection for the frame-conv and resampling paths.

The policy is ``golf_tpu.ops.fftsize``'s default: the smallest
``2^a * m >= n`` with ``m`` in {1, 3, 5, 9, 15, 45}. Keeping the same sizes
keeps the port's circular convolutions identical to the reference's.
"""

from __future__ import annotations

_FAST_ODD = (1, 3, 5, 9, 15, 45)


def fast_fft_size(n: int) -> int:
    """Smallest 2^a * m >= n with m in the fast odd family."""
    best = 1 << (n - 1).bit_length()
    for m in _FAST_ODD[1:]:
        c = m
        while c < n:
            c *= 2
        best = min(best, c)
    return best


def conv_fft_size(n: int) -> int:
    return fast_fft_size(n)
