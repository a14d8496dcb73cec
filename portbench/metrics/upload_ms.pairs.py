"""Device ms a request of the copies from the host to the card: the
uploads of the request's volumes from host memory (api / batch entry
layer)."""


def read(s: dict):
    ms = s.get("upload_ms")
    if not s.get("requests") or not ms:
        return None
    return ms / s["requests"]
