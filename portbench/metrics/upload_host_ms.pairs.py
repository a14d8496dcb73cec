"""Host ms a request spends in the port's ``sift3d.upload`` spans: how
long the copy of the request's volumes to the card holds the caller (api
and batch entry layer)."""


def read(s: dict):
    ms = s.get("span_host_ms", {}).get("sift3d.upload")
    if not s.get("requests") or not ms:
        return None
    return ms / s["requests"]
