"""The expert store's hits over hits and loads in the window
(`ExpertStore.stats`): the share of the needed experts already resident."""


def read(rec):
    st = rec.get("store")
    if not st or st["hits"] + st["loads"] == 0:
        return None
    return 100.0 * st["hits"] / (st["hits"] + st["loads"])
