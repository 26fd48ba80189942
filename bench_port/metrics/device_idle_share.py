"""device_idle_share: share of the traced slice in which no operation ran
on the device."""


def read(run):
    tr = run.trace
    if tr is None or tr.wall_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
