"""Host ms a request spends in the port's ``sift3d.extrema`` spans (DoG
extrema; bound by one host sync a level)."""


def read(s: dict):
    ms = s.get("span_host_ms", {}).get("sift3d.extrema")
    if not s.get("requests") or not ms:
        return None
    return ms / s["requests"]
