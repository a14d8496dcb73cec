"""Host ms a request spends in the port's ``sift3d.sync.<stage>`` spans,
every stage summed: the host blocked on the card at the path's deliberate
device-to-host reads (device layer)."""


def read(s: dict):
    ms = [v for k, v in s.get("span_host_ms", {}).items()
          if k.startswith("sift3d.sync.")]
    if not s.get("requests") or not ms:
        return None
    return sum(ms) / s["requests"]
