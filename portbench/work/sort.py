"""Sort (emission and stable sort of the exact frame's pairs): the live
pairs written once as the frame's (int64 key, int32 value) output, and the
per-splat fields the reference's emission reads once each: the valid flag
(1 byte), the tile rect (4 int32), the tile count and the depth key (int32
each)."""

PAIR_BYTES = 8 + 4
SPLAT_BYTES = 1 + 16 + 4 + 4


def work(run, counts):
    return 0.0, float(counts["live_pairs"] * PAIR_BYTES
                      + run.capacity * SPLAT_BYTES)
