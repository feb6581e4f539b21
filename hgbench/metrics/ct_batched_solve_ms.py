"""Mean time of one batched CT window solve in the window (ms): the
program's section ct.batched_solve (hg_section_seconds), B windows in one
solve_ct_window_batched on the server's SLAM thread, ending where the
solve itself last waits on the card (layer: CT front end)."""


def read(readings):
    total, count = readings.get("sections", {}).get("ct.batched_solve", (0.0, 0))
    return None if count == 0 else 1e3 * total / count
