"""The window's milliseconds over the updates it completed (host clock;
each update includes the staging of its measurement)."""


def read(rec):
    return 1e3 * rec["window_s"] / rec["units"]
