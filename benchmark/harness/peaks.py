"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and K1's operations and bytes."""
from __future__ import annotations

INT8_OPS_PER_S = 1979e12      # dense int8 tensor-core peak; no b1 rate is
#                               published
HBM_BYTES_PER_S = 3.35e12


def k1_ops(n: int, v: int) -> float:
    """Bit-products of an (N, 8) x (V, 8) nearest-codeword search: every
    descriptor's 256 bits against every codeword's, counted as a multiply
    and an add."""
    return 2.0 * n * v * 256


def k1_bytes(n: int, v: int) -> float:
    """Descriptors and codewords read once (32 bytes each), a distance and
    an index written per descriptor (8 bytes)."""
    return n * 32.0 + v * 32.0 + n * 8.0


def k1_least_s(n: int, v: int) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(k1_ops(n, v) / INT8_OPS_PER_S, k1_bytes(n, v) / HBM_BYTES_PER_S)


def k1_roofline_pct(rec):
    """100 * the least time of the traced K1 calls over their profiled
    device time. Each profiled K1 kernel is paired with the (N, V) of its
    launch: one by one when the wrapper saw every launch of the traced
    stretch, else by the one shape the process ever launched (a replayed
    graph's K1 is seen once, at capture). None when it cannot pair them."""
    t = rec.get("trace")
    if not t or not t["k1_seconds"]:
        return None
    secs = t["k1_seconds"]
    shapes = t.get("k1_shapes_traced", [])
    if len(shapes) != len(secs):
        every = set(rec["k1_shapes"]) | set(rec.get("k1_shapes_setup", []))
        if len(every) != 1:
            return None
        shapes = [next(iter(every))] * len(secs)
    least = sum(k1_least_s(n, v) for n, v in shapes)
    return 100.0 * least / sum(secs)
