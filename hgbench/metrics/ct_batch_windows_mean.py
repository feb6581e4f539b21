"""Mean CT windows per window solve in the window (windows): the
program's histogram hg_ct_batch_windows (B for a batched solve, 1 for a
window solved alone) over the solves of the window (layer: CT batcher).
Nothing where the program has no such histogram."""


def read(readings):
    total, count = readings.get("batch_windows", (0.0, 0))
    return None if count == 0 else total / count
