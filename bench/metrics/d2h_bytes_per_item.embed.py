"""Bytes of the int4 activation cache copied from the card to the host a
photo in the window (the store's ``act_d2h_bytes``)."""


def read(rec):
    c = rec["counters"]
    return c["act_d2h_bytes"] / c["items"] if c["items"] else None
