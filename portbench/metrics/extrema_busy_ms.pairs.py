"""Device busy ms a request of the work launched inside the port's
``sift3d.extrema`` spans and the ``sift3d.sync.extrema`` spans nested in
them: the DoG compare kernels and the scans of ``nonzero`` (extrema
layer)."""

SPANS = ("sift3d.extrema", "sift3d.sync.extrema")


def read(s: dict):
    busy = s.get("span_busy_ms", {})
    ms = sum(busy.get(k, 0.0) for k in SPANS)
    if not s.get("requests") or not ms:
        return None
    return ms / s["requests"]
