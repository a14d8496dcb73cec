"""Share (%) of the traced slice's wall time in which no kernel, memcpy
or memset ran on the card (device layer)."""


def read(s: dict):
    if not s.get("wall_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])
