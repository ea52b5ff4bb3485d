"""Mean milliseconds a call in the latent stage (the span around the program's
method, CUDA events; the stage's idle gaps included)."""


def read(r):
    spans = r.spans_ms.get("latent_ms")
    return sum(spans) / r.calls if spans else None
