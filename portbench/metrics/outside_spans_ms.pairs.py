"""Host ms a request spends outside every ``sift3d.<stage>`` span of the
port: uploads, the pyramid plan, copies back and the entry's own glue
(api / batch entry layer)."""


def read(s: dict):
    if not s.get("requests"):
        return None
    return s["outside_ms"] / s["requests"]
