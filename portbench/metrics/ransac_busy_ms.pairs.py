"""Device busy ms a request of the work launched inside the port's
``sift3d.ransac`` spans: the hypotheses, their consensus, the
least-squares refit and the affine back to voxels (matching, RANSAC
layer)."""


def read(s: dict):
    ms = s.get("span_busy_ms", {}).get("sift3d.ransac")
    if not s.get("requests") or not ms:
        return None
    return ms / s["requests"]
