"""LM tries of lm_run completed in the window over the window's seconds
(host clock)."""


def read(rec):
    return rec["units"] / rec["window_s"]
