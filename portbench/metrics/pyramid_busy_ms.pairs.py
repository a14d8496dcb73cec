"""Device busy ms a request of the work launched inside the port's
``sift3d.pyramid`` spans: scaling, the Gaussian blurs and the DoG
(pyramid layer). The upload of the volumes, which the port also runs in
that span, is left out (``upload_ms.pairs``)."""


def read(s: dict):
    ms = s.get("span_busy_ms", {}).get("sift3d.pyramid")
    if not s.get("requests") or not ms:
        return None
    return ms / s["requests"]
