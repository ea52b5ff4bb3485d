"""Mean milliseconds a call in the encode stage (the span around the program's
method, CUDA events; the stage's idle gaps included)."""


def read(r):
    spans = r.spans_ms.get("encode_ms")
    return sum(spans) / r.calls if spans else None
