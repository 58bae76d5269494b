"""Tokens `SiDADecodeEngine.generate` emitted in the window, over the
window's seconds (host clock; the window ends when the last call has
returned, its tokens on the host)."""


def read(rec):
    if "steps" not in rec:
        return None
    return rec["tokens"] / rec["window_s"]
