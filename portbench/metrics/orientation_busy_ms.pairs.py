"""Device busy ms a request of the work launched inside the port's
``sift3d.orientation`` spans and the ``sift3d.sync.orientation`` spans
nested in them: kernel 3 and the keep's compaction (orientation layer)."""

SPANS = ("sift3d.orientation", "sift3d.sync.orientation")


def read(s: dict):
    busy = s.get("span_busy_ms", {})
    ms = sum(busy.get(k, 0.0) for k in SPANS)
    if not s.get("requests") or not ms:
        return None
    return ms / s["requests"]
