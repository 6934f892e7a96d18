"""LM tries completed in the window over the window's seconds (host
clock; the window ends with the synchronize after the solve that crosses
--seconds)."""


def read(rec):
    return rec["units"] / rec["window_s"]
