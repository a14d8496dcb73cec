"""Device busy ms a request of the work launched inside the port's
``sift3d.match`` spans: the ratio-test matching of every pair and the
compaction of the matched coordinates (matching, RANSAC layer)."""


def read(s: dict):
    ms = s.get("span_busy_ms", {}).get("sift3d.match")
    if not s.get("requests") or not ms:
        return None
    return ms / s["requests"]
