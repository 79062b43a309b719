"""Texts per encoder tile over the window (the text frontend's
``n_texts`` over ``n_encode_batches``)."""


def read(rec):
    c = rec.get("counters") or {}
    if not c.get("n_encode_batches"):
        return None
    return c["n_texts"] / c["n_encode_batches"]
