"""Runtime programmability helpers (the part of ``repro.core.flexible`` the
serving engine uses)."""
from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (next_pow2(1) == 1)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()
